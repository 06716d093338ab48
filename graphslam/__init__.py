"""graphslam — a graph-SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
reference C++/ROS stack (Sergimech/GraphSLAM): laser-scan frontend
(projection + GICP-class scan matching), keyframe/factor bookkeeping with
loop-closure search, and a sparse Gauss-Newton / Levenberg-Marquardt
pose-graph backend — all as batched, jittable array programs over a
`jax.sharding.Mesh`.

Layer map (new stack ⇔ reference):
  geometry/   ⇔ gtsam::Pose2 + Eigen plumbing (graph.hpp, scanner.hpp)
  factors/    ⇔ gtsam::NonlinearFactorGraph factor construction (graph.cpp)
  solver/     ⇔ gtsam::LevenbergMarquardtOptimizer (graph.cpp:115-132)
  frontend/   ⇔ PCL GICP + laser_geometry (scanner.cpp)
  slam/       ⇔ the scanner+graph+odometry ROS-node trio, fused in-process
  parallel/   ⇔ (new) multi-device/multi-host scaling over collectives
  ops/        ⇔ (new) hand-written GPU kernels (the GICP IRLS iteration)
  io/         ⇔ (new) g2o datasets, checkpointing — the reference had none
  sim/        ⇔ Stage simulator (willow.world) as a deterministic replay sim
"""

__version__ = "0.1.0"

from graphslam import geometry  # noqa: F401
from graphslam.config import (  # noqa: F401
    FrontendConfig,
    MeshConfig,
    SLAMConfig,
    SolverConfig,
)


def __getattr__(name):
    """Lazy top-level conveniences (keep bare import light)."""
    import importlib

    lazy = {
        "from_dataset": ("graphslam.factors", "from_dataset"),
        "lm_solve": ("graphslam.solver", "lm_solve"),
        "gn_solve": ("graphslam.solver", "gn_solve"),
        "run_slam": ("graphslam.slam", "run_slam"),
        "load": ("graphslam.io.datasets", "load"),
        "ate": ("graphslam.metrics", "ate"),
    }
    if name in lazy:
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'graphslam' has no attribute {name!r}")
