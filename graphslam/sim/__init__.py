"""Deterministic 2D laser/robot simulator — the Stage replacement.

The reference's only validation harness was the Stage simulator with the
Willow Garage floorplan driven by a human (SURVEY.md §4). This package is the
batch-testable equivalent: a segment world, a vectorized raycaster with the
same laser model (1081 beams, 270.25 deg, 30 m — willow.world:8-14), a
differential-drive integrator, and scripted trajectories for closed-loop
frontend tests.
"""

from graphslam.sim.world import (  # noqa: F401
    World,
    default_world,
    raycast,
    simulate_trajectory,
)
from graphslam.sim.grid import (  # noqa: F401
    GridWorld,
    load_pgm,
    rasterize_world,
    raycast_grid,
)
