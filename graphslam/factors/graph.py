"""FactorGraph: the pose-graph problem as a pytree of flat arrays.

Layout (struct-of-arrays, SURVEY.md §7.2):
  edges        (E, 2) int32   between-factor endpoints (i, j)
  measurements (E, D)         relative pose z_ij (D=3 for SE2, 12 for SE3)
  sqrt_info    (E, T, T)      upper Cholesky factor of the information matrix
                              (T=3 / 6); whitening is one small matmul
  edge_mask    (E,)  bool     validity (preallocated online graphs grow by
                              flipping mask bits, never by reshaping)
  is_loop      (E,)  bool     loop-closure edges (robust-kernel scope)
  prior_idx    (P,)  int32    anchored nodes
  prior_meas   (P, D)         anchor poses
  prior_sqrt_info (P, T, T)
  prior_mask   (P,)  bool

Everything is fixed-shape so the whole optimizer jits once and never
recompiles as the graph grows (reference kept growing std::vectors,
graph.cpp:5-10).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp
import numpy as np

from graphslam.pytree import pytree_dataclass, static_field


@pytree_dataclass
class FactorGraph:
    edges: jnp.ndarray
    measurements: jnp.ndarray
    sqrt_info: jnp.ndarray
    edge_mask: jnp.ndarray
    is_loop: jnp.ndarray
    prior_idx: jnp.ndarray
    prior_meas: jnp.ndarray
    prior_sqrt_info: jnp.ndarray
    prior_mask: jnp.ndarray

    # Static (trace-time) structure hint: the first `chain_prefix` edges are
    # exactly (k, k+1) — the odometry chain. Their Hessian/gradient
    # contributions assemble with static slice-adds instead of scatters
    # (solver/normal_eq.py); 0 disables the fast path.
    chain_prefix: int = static_field(default=0)

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def tangent_dim(self) -> int:
        return self.sqrt_info.shape[-1]

    @property
    def pose_dim(self) -> int:
        return self.measurements.shape[-1]


def _chol_info(info: np.ndarray) -> np.ndarray:
    """Upper sqrt-information: info = U^T U with U upper triangular, so the
    whitened residual is U @ r."""
    L = np.linalg.cholesky(info)  # info = L L^T
    return np.swapaxes(L, -1, -2)


def _chain_reorder(edges: np.ndarray, n_poses: int):
    """Permutation putting one (k, k+1) edge at position k for the longest
    possible k-run (the odometry chain), remaining edges after — enabling the
    solver's scatter-free chain fast path on arbitrarily-ordered (real g2o)
    edge lists. Returns (perm, chain_prefix)."""
    E = edges.shape[0]
    slot = {}
    for e in range(E):
        i, j = int(edges[e, 0]), int(edges[e, 1])
        if j == i + 1 and i not in slot:
            slot[i] = e
    prefix = []
    for k in range(n_poses - 1):
        if k in slot:
            prefix.append(slot[k])
        else:
            break
    chain = set(prefix)
    rest = [e for e in range(E) if e not in chain]
    return np.asarray(prefix + rest, np.int64), len(prefix)


def from_dataset(
    data: Dict[str, np.ndarray],
    prior_sigma: float = 0.1,
    dtype=jnp.float32,
) -> FactorGraph:
    """Build a FactorGraph from a g2o/synthetic dataset dict, anchoring node 0
    with an isotropic prior (sigma = reference's graph.cpp:13-14 default)."""
    edges = np.asarray(data["edges"], np.int32)
    meas = np.asarray(data["measurements"])
    info = np.asarray(data["information"])
    E = edges.shape[0]
    T = info.shape[-1]
    is_loop = np.asarray(
        data.get("is_loop", edges[:, 1] != edges[:, 0] + 1), bool
    )

    n_poses = np.asarray(data["poses"]).shape[0]
    perm, chain_prefix = _chain_reorder(edges, n_poses)
    edges = edges[perm]
    meas = meas[perm]
    info = info[perm]
    is_loop = is_loop[perm]

    prior_idx = np.zeros((1,), np.int32)
    prior_meas = np.asarray(data["poses"])[0:1]
    prior_info = np.eye(T)[None] / (prior_sigma**2)

    return FactorGraph(
        chain_prefix=chain_prefix,
        edges=jnp.asarray(edges),
        measurements=jnp.asarray(meas, dtype),
        sqrt_info=jnp.asarray(_chol_info(info), dtype),
        edge_mask=jnp.ones((E,), bool),
        is_loop=jnp.asarray(is_loop),
        prior_idx=jnp.asarray(prior_idx),
        prior_meas=jnp.asarray(prior_meas, dtype),
        prior_sqrt_info=jnp.asarray(_chol_info(prior_info), dtype),
        prior_mask=jnp.ones((1,), bool),
    )
