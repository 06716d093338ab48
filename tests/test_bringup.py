"""What the entry points rely on: the pytree dataclass, the compile-cache
placement, and chip_smoke.py refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from graphslam import utils
from graphslam.pytree import pytree_dataclass, static_field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytree_dataclass
class _Box:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = static_field(default=0)


def test_pytree_flatten_unflatten():
    box = _Box(a=jnp.ones(3), b=jnp.zeros((2, 2)), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(box)
    assert len(leaves) == 2  # the static field is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n == 5 and back.a.shape == (3,) and back.b.shape == (2, 2)
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, box)
    assert doubled.n == 5 and float(doubled.a[0]) == 2.0


def test_pytree_static_field_retraces():
    traces = []

    @jax.jit
    def f(box):
        traces.append(box.n)
        return box.a * box.n

    assert float(f(_Box(jnp.ones(2), jnp.ones(2), n=2))[0]) == 2.0
    assert float(f(_Box(jnp.ones(2), jnp.ones(2), n=2))[0]) == 2.0
    assert float(f(_Box(jnp.ones(2), jnp.ones(2), n=3))[0]) == 3.0
    assert traces == [2, 3]  # a new static value is a new trace, not a leaf


def test_pytree_replace_and_frozen():
    box = _Box(jnp.ones(2), jnp.ones(2), n=1)
    new = box.replace(a=jnp.zeros(2), n=4)
    assert new.n == 4 and float(new.a[0]) == 0.0
    assert box.n == 1 and float(box.a[0]) == 1.0  # the original is unchanged
    with pytest.raises(Exception):
        box.n = 3


def _cache_dir_after(monkeypatch, env_value):
    old = jax.config.jax_compilation_cache_dir
    try:
        if env_value is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
        returned = utils.enable_compile_cache()
        return returned, jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    returned, configured = _cache_dir_after(monkeypatch, None)
    expected = os.path.join(ROOT, ".jax_cache")
    assert returned == configured == expected
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    returned, configured = _cache_dir_after(monkeypatch, str(tmp_path))
    assert returned == str(tmp_path)
    assert configured == before  # nothing set: JAX reads the variable itself


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("GRAPHSLAM_TEST_GPU", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a CUDA GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
