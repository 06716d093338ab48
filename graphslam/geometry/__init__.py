"""Batched Lie-group geometry for SLAM states.

Replaces gtsam::Pose2/Pose3 and the reference's (buggy) hand-rolled SE(2)
helpers — compose at graph.hpp:30-43 drops the base translation, make_Delta
at scanner.hpp:55-61 uses atan instead of atan2 (SURVEY.md §3.6.1/4). All ops
here are pure jnp, broadcast over arbitrary leading batch dims, and are safe
under jit/vmap/grad.
"""

from graphslam.geometry import se2, se3, so2, so3  # noqa: F401
