"""Factor-graph data layer: struct-of-arrays storage + batched linearization.

Replaces gtsam::NonlinearFactorGraph/Values and the factor construction in
the reference backend (prior_factor graph.cpp:27-61, new_factor :63-95,
loop_factor :97-113). Per-factor virtual dispatch becomes one vmapped
linearization kernel over contiguous arrays (SURVEY.md §2.4 item 1).
"""

from graphslam.factors.graph import FactorGraph, from_dataset  # noqa: F401
from graphslam.factors.linearize import (  # noqa: F401
    linearize,
    residuals,
    chi2,
)
