"""Observability and entry-point set-up: timers, counters, structured
logging, profiler hooks, the device check and the compile cache.

The reference's observability was commented-out ROS_INFO pairs used as ad-hoc
trace points (scanner.cpp:14,19,36,72; graph.cpp:29,65,116 — SURVEY.md §5).
This module is the real version: accumulating wall-clock timers around
pipeline stages, event counters (keyframes, loop closures, solves), and
optional jax.profiler trace capture.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import jax

logger = logging.getLogger("graphslam")

# Fixed, so that one checkout's runs find each other's entries.
COMPILE_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
    is changed; otherwise the cache goes to .jax_cache/ at the root of the
    checkout (gitignored)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(COMPILE_CACHE_DIR))
    return str(COMPILE_CACHE_DIR)


def require_gpu():
    """The first JAX device, which must be a GPU: measurement entry points
    stop here rather than run on another platform."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"error: needs a CUDA GPU, but JAX found {dev.platform} "
            f"({dev.device_kind}); nothing was measured"
        )
    return dev


def sync(tree):
    """Block until every array in `tree` is computed; returns `tree`."""
    return jax.block_until_ready(tree)


class Stopwatch:
    """Accumulating per-stage timers: `with sw.time("solve"): ...`."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.total[k],
                "count": self.count[k],
                "mean_ms": 1e3 * self.total[k] / max(self.count[k], 1),
            }
            for k in sorted(self.total)
        }

    def log_summary(self):
        for k, v in self.summary().items():
            logger.info(
                "%-20s %6d calls  %8.2f ms/call  %8.3f s total",
                k, v["count"], v["mean_ms"], v["total_s"],
            )


class Counters:
    """SLAM event counters (the ROS_INFO tallies, queryable)."""

    def __init__(self):
        self.values: Dict[str, int] = defaultdict(int)

    def bump(self, name: str, by: int = 1):
        self.values[name] += by

    def as_dict(self) -> Dict[str, int]:
        return dict(self.values)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard format) around a block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
