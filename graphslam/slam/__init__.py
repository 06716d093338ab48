"""Online incremental SLAM pipeline.

Collapses the reference's three processes + five topics + three services
(scanner node, graph node, odometry node — SURVEY.md §1) into one jitted
step function over a preallocated `SLAMState`: keyframe decision, loop
candidate search, factor append, periodic solve — the array-program answer
to ROS (SURVEY.md §7.4). Notably it *enables* the solve the reference left
commented out (graph.cpp:195).
"""

from graphslam.slam.state import SLAMState, init_state  # noqa: F401
from graphslam.slam.pipeline import make_slam_step, run_slam, StepInfo  # noqa: F401
from graphslam.slam.odometry import OdometryBuffer, integrate_twist  # noqa: F401
