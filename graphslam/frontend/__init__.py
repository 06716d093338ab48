"""Laser-scan frontend: projection + GICP-class scan matching.

Replaces the reference scanner node (scanner.cpp) and the two native engines
it leaned on — laser_geometry's projectLaser and PCL's
GeneralizedIterativeClosestPoint (SURVEY.md §2.2). Everything is
fixed-shape, masked, vmappable, and jit-compiled once.
"""

from graphslam.frontend.projection import scan_to_points  # noqa: F401
from graphslam.frontend.icp import (  # noqa: F401
    estimate_normals,
    gicp_match,
    MatchResult,
)
from graphslam.frontend.keyframes import motion_covariance  # noqa: F401
