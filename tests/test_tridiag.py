"""Cyclic-reduction block-tridiagonal solver vs dense reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphslam.solver.tridiag import cr_factor, cr_solve, chain_offdiag


def random_spd_tridiag(n, T=3, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(max(n - 1, 0), T, T)).astype(np.float32) * 0.3
    D = []
    for k in range(n):
        M = rng.normal(size=(T, T)).astype(np.float32)
        D.append(M @ M.T + 3.0 * np.eye(T, dtype=np.float32))
    D = np.stack(D)
    return jnp.asarray(D), jnp.asarray(U)


def dense_from_tridiag(D, U):
    n, T, _ = D.shape
    A = np.zeros((n * T, n * T), np.float64)
    for k in range(n):
        A[k * T:(k + 1) * T, k * T:(k + 1) * T] = D[k]
    for k in range(n - 1):
        A[k * T:(k + 1) * T, (k + 1) * T:(k + 2) * T] = U[k]
        A[(k + 1) * T:(k + 2) * T, k * T:(k + 1) * T] = U[k].T
    return A


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 17, 64, 129])
def test_cr_matches_dense(n):
    D, U = random_spd_tridiag(n, seed=n)
    b = jnp.asarray(
        np.random.default_rng(100 + n).normal(size=(n, 3)).astype(np.float32)
    )
    # eps=0: exact solve (the default eps>0 is a deliberate preconditioner
    # ridge and only needs to be *approximately* T^-1).
    fac = cr_factor(D, U, eps=0.0)
    x = cr_solve(fac, b)
    A = dense_from_tridiag(np.asarray(D), np.asarray(U))
    x_ref = np.linalg.solve(A, np.asarray(b, np.float64).reshape(-1)).reshape(n, 3)
    assert np.allclose(x, x_ref, rtol=2e-3, atol=2e-4), np.abs(x - x_ref).max()


def test_cr_with_ridge_is_close():
    D, U = random_spd_tridiag(64, seed=3)
    b = jnp.ones((64, 3))
    x0 = cr_solve(cr_factor(D, U, eps=0.0), b)
    x1 = cr_solve(cr_factor(D, U), b)
    # The default ridge perturbs the solve by O(eps * cond).
    rel = float(jnp.linalg.norm(x1 - x0) / jnp.linalg.norm(x0))
    assert rel < 0.05, rel


def test_cr_jit_and_grad_safe():
    D, U = random_spd_tridiag(33, seed=7)
    b = jnp.ones((33, 3))
    f = jax.jit(lambda b_: cr_solve(cr_factor(D, U), b_))
    x = f(b)
    assert np.all(np.isfinite(x))


def test_chain_offdiag_extraction():
    edges = jnp.array([[0, 1], [1, 2], [0, 2], [2, 3]], jnp.int32)
    Aij = jnp.arange(4 * 9, dtype=jnp.float32).reshape(4, 3, 3)
    U = chain_offdiag(edges, Aij, 4)
    assert U.shape == (3, 3, 3)
    assert np.allclose(U[0], Aij[0])
    assert np.allclose(U[1], Aij[1])
    assert np.allclose(U[2], Aij[3])  # the (0,2) loop edge must be excluded
