"""GICP-class SE(2) scan matcher — the JAX rebuild of PCL's
GeneralizedIterativeClosestPoint (scanner.cpp:35-74, SURVEY.md §2.2).

Design (brute force on the accelerator, not a kd-tree translation):
  * Correspondence = brute-force pairwise squared distances from exact
    coordinate differences + masked argmin over the 1152-point budget.
  * Per-point surfel covariances from a fixed half-window line fit along the
    (angularly ordered) scan — the 2D analog of PCL GICP's k-NN covariances.
  * Plane-to-plane Mahalanobis weighting: M = (C_t + R C_s R^T + eps I)^-1,
    IRLS Gauss-Newton on the 3-dof SE(2) delta; the 3x3 normal system is
    solved in closed form.
  * IRLS under an early-exit lax.while_loop (static shapes; a fixed-count
    lax.scan with early_exit=False); each iteration runs either as XLA ops
    or as one GPU kernel (ops/icp_kernel.py). Convergence is reported as a
    flag, matching hasConverged()+fitness gating
    semantics of the reference (scanner.cpp:49-70, fixing SURVEY.md §3.6.3
    by separating the motion gate from the quality gate).

The matcher is pure-functional and vmaps over batches of scan pairs — the
reference ran its two GICP calls (odometry + loop probe) serially
(scanner.cpp:115,141); here they run as one batched call.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from graphslam.geometry import se2, so2
from graphslam.ops import on_gpu


class MatchResult(NamedTuple):
    delta: jnp.ndarray        # (3,) SE(2) source->target transform estimate
    fitness: jnp.ndarray      # () PCL getFitnessScore semantics: mean squared
                              #    NN distance over ALL valid source points,
                              #    ungated — grows with scan novelty, which is
                              #    exactly what the reference's keyframe
                              #    motion gate thresholds (scanner.cpp:49,57)
    inlier_rms: jnp.ndarray   # () RMS distance over gated correspondences
                              #    (match quality, small = good alignment)
    matched_frac: jnp.ndarray # () fraction of source points with a match
    converged: jnp.ndarray    # () bool: final GN update below tolerance
    mahal_rmse: jnp.ndarray   # () sqrt(mean Mahalanobis residual)
    degenerate: jnp.ndarray   # () bool: the 3x3 GN Hessian is rank-deficient
                              #    (corridor case: translation along the wall
                              #    unobservable — the delta slides freely and
                              #    must not be trusted as a factor)
    hessian: jnp.ndarray      # (3, 3) final IRLS Gauss-Newton Hessian
                              #    J^T M J — the Fisher information of the
                              #    registration; scaled, it provides the
                              #    match-informed factor covariance (fixes
                              #    scanner.hpp:64-80's magnitude-only model)


def estimate_normals(points: jnp.ndarray, mask: jnp.ndarray, half_window: int):
    """Windowed line fit along the scan: returns (normals (P,2), covs (P,2,2))
    where covs are GICP surfel covariances R diag(1, eps) R^T scaled later.

    Uses cumulative sums over the beam axis — O(P), fully vectorized.
    """
    P = points.shape[0]
    w = jnp.where(mask, 1.0, 0.0)[:, None]
    pw = points * w

    def windowed_sum(x):
        # Inclusive prefix sums; window [i-h, i+h] via two gathers.
        c = jnp.cumsum(x, axis=0)
        c = jnp.concatenate([jnp.zeros_like(c[:1]), c], axis=0)  # (P+1, ...)
        idx = jnp.arange(P)
        lo = jnp.clip(idx - half_window, 0, P)
        hi = jnp.clip(idx + half_window + 1, 0, P)
        return c[hi] - c[lo]

    n = windowed_sum(w)                     # (P, 1) count
    s1 = windowed_sum(pw)                   # (P, 2) sum
    outer = pw[:, :, None] * points[:, None, :]
    s2 = windowed_sum(outer.reshape(P, 4)).reshape(P, 2, 2)

    n_safe = jnp.maximum(n, 1.0)
    mean = s1 / n_safe
    cov = s2 / n_safe[..., None] - mean[:, :, None] * mean[:, None, :]
    cov = cov + 1e-8 * jnp.eye(2)

    # Closed-form 2x2 eigendecomposition; normal = minor eigenvector.
    a, b, c_ = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    tr = a + c_
    det_half = jnp.sqrt(jnp.maximum(((a - c_) / 2) ** 2 + b * b, 1e-20))
    lam_min = tr / 2 - det_half
    # Eigenvector for lam_min: (b, lam_min - a) or (lam_min - c, b).
    v1 = jnp.stack([b, lam_min - a], axis=-1)
    v2 = jnp.stack([lam_min - c_, b], axis=-1)
    use_v1 = jnp.sum(v1 * v1, axis=-1) > jnp.sum(v2 * v2, axis=-1)
    v = jnp.where(use_v1[:, None], v1, v2)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-20))
    normals = v / norm
    return normals, cov


def surfel_covs(points, mask, half_window: int, eps: float):
    """GICP covariances: unit variance along the fitted line, eps across."""
    normals, _ = estimate_normals(points, mask, half_window)
    n = normals
    t = jnp.stack([-n[:, 1], n[:, 0]], axis=-1)  # tangent
    # C = t t^T * 1 + n n^T * eps
    C = t[:, :, None] * t[:, None, :] + eps * (n[:, :, None] * n[:, None, :])
    return C


def _sym3x3_eigvals(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of a symmetric 3x3 (ascending), closed trigonometric form
    (Smith's algorithm) — branch-free, works under jit/vmap."""
    q = jnp.trace(A) / 3.0
    B = A - q * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B / p)
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return jnp.stack([e3, e2, e1])


def _pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(Na,2),(Nb,2) -> (Na,Nb) squared distances, exact coordinate
    differences. (The ||a||^2+||b||^2-2ab matmul identity loses precision
    in a reduced-precision dot, TF32 or bf16, and can flip nearest
    neighbors between close scan points.)"""
    dx = a[:, 0:1] - b[None, :, 0]
    dy = a[:, 1:2] - b[None, :, 1]
    return dx * dx + dy * dy


def _irls_terms_xla(delta, src_pts, src_mask, tgt_pts, tgt_mask, Cs, Ct,
                    max_corr2):
    """One IRLS iteration's normal equations (H, g) and match statistics
    [sum_d2_all, sum_d2_gated, n_match, sum_mahal], as plain XLA ops."""
    dtype = src_pts.dtype
    moved = se2.transform(delta, src_pts)
    c, s = jnp.cos(delta[2]), jnp.sin(delta[2])
    dR = jnp.array([[-s, -c], [c, -s]], dtype)
    jtheta = jnp.dot(src_pts, dR.T, precision=jax.lax.Precision.HIGHEST)  # (P, 2)

    d2 = _pairwise_sqdist(moved, tgt_pts)
    d2 = jnp.where(tgt_mask[None, :], d2, jnp.asarray(1e9, dtype))
    nn = jnp.argmin(d2, axis=1)
    nn_d2 = jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0]
    good = src_mask & (nn_d2 <= max_corr2)
    wv = jnp.where(good, 1.0, 0.0)

    q = tgt_pts[nn]
    Ctn = Ct[nn]
    R = so2.rotmat(delta[2])
    Csr = jnp.einsum("ab,nbc,dc->nad", R, Cs, R, precision=jax.lax.Precision.HIGHEST)
    M = jnp.linalg.inv(Ctn + Csr + 1e-6 * jnp.eye(2, dtype=dtype))

    e = q - moved                                          # (P, 2)
    # J = d(moved)/d(dx,dy,dtheta) = [I2 | dR/dtheta @ p_src]
    J = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(2, dtype=dtype), (src_pts.shape[0], 2, 2)),
         jtheta[:, :, None]],
        axis=-1,
    )                                                      # (P, 2, 3)
    # The sums over points are matrix products; at default precision a GPU
    # runs them in TF32, which moves the converged delta by ~1e-4.
    hi = jax.lax.Precision.HIGHEST
    MJ = jnp.einsum("nab,nbc->nac", M, J, precision=hi)
    H = jnp.einsum("nba,nbc,n->ac", J, MJ, wv, precision=hi)
    g = jnp.einsum("nba,nbc,nc->a", J, M, e * wv[:, None], precision=hi)
    wall = jnp.where(src_mask, 1.0, 0.0)
    stats = jnp.stack([
        jnp.sum(nn_d2 * wall),  # ungated (PCL fitness numerator)
        jnp.sum(nn_d2 * wv),
        jnp.sum(wv),
        jnp.sum(jnp.einsum("na,nab,nb->n", e, M, e, precision=hi) * wv),
    ])
    return H, g, stats


@partial(
    jax.jit,
    # max_corr_dist/gicp_eps are static: the GICP kernel bakes them in as
    # Python floats.
    static_argnames=(
        "iterations", "half_window", "use_pallas", "interpret",
        "max_corr_dist", "gicp_eps", "early_exit",
    ),
)
def gicp_match(
    src_pts: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_pts: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    init_delta: jnp.ndarray | None = None,
    iterations: int = 16,
    max_corr_dist: float = 1.0,
    half_window: int = 4,
    gicp_eps: float = 1e-3,
    tol: float = 1e-5,
    degeneracy_ratio: float = 1e-3,
    use_pallas: bool | None = None,
    interpret: bool = False,
    early_exit: bool = True,
) -> MatchResult:
    """Estimate the SE(2) transform mapping source scan into the target
    frame. Everything static-shape; masked points never contribute.

    use_pallas: run each IRLS iteration as one GPU kernel
    (ops/icp_kernel.py) instead of XLA ops. None chooses by the platform the
    computation is compiled for: the kernel on a CUDA device, XLA elsewhere.
    True always uses the kernel, which compiles only for a CUDA device
    unless `interpret=True` asks for the Pallas interpreter (tests)."""
    dtype = src_pts.dtype
    delta0 = jnp.zeros(3, dtype) if init_delta is None else init_delta

    Ct = surfel_covs(tgt_pts, tgt_mask, half_window, gicp_eps)
    Cs = surfel_covs(src_pts, src_mask, half_window, gicp_eps)
    max_corr2 = float(max_corr_dist) ** 2
    inputs = (src_pts, src_mask, tgt_pts, tgt_mask, Cs, Ct)

    def xla_terms(delta):
        return _irls_terms_xla(delta, *inputs, max_corr2)

    def kernel_terms(delta):
        from graphslam.ops.icp_kernel import fused_icp_iteration

        return fused_icp_iteration(
            delta, src_pts, src_mask, Cs, tgt_pts, tgt_mask, Ct,
            max_corr2=max_corr2, eps=1e-6, interpret=interpret,
        )

    def step(delta, _):
        if use_pallas is None:
            H, g, st = on_gpu(kernel_terms, xla_terms, delta)
        elif use_pallas:
            H, g, st = kernel_terms(delta)
        else:
            H, g, st = xla_terms(delta)
        H = H + 1e-6 * jnp.eye(3, dtype=dtype)
        upd = jnp.linalg.solve(H, g)
        new_delta = jnp.concatenate(
            [delta[:2] + upd[:2], so2.wrap(delta[2] + upd[2])[None]]
        )
        stats = (st[0], st[1], st[2], st[3], jnp.linalg.norm(upd), H)
        return new_delta, stats

    if early_exit:
        # Data-dependent trip count: stop once the update norm drops below
        # tol (PCL GICP's own convergence test). Typical scans converge well
        # inside the 32-iteration budget; the fixed-length scan path below
        # is kept for exactly-reproducible iteration counts
        # (early_exit=False).
        delta1, stats1 = step(delta0, None)

        def cond(c):
            k, _, st = c
            return (k < iterations) & (st[4] >= tol)

        def body(c):
            k, d, _ = c
            nd, nst = step(d, None)
            return k + 1, nd, nst

        _, delta, stats_last = jax.lax.while_loop(
            cond, body, (jnp.int32(1), delta1, stats1)
        )
        sum_d2_all, sum_d2, n_match, sum_mahal, last_upd, H_last = stats_last
    else:
        delta, stats = jax.lax.scan(step, delta0, None, length=iterations)
        sum_d2_all, sum_d2, n_match, sum_mahal, last_upd, H_last = (
            jax.tree_util.tree_map(lambda x: x[-1], stats)
        )
    # Degeneracy: normalize the translation block's scale against rotation
    # (units differ); compare the smallest Hessian eigenvalue to the largest.
    eigs = _sym3x3_eigvals(H_last)
    degenerate = eigs[0] < degeneracy_ratio * eigs[2]
    n_src = jnp.maximum(jnp.sum(jnp.where(src_mask, 1.0, 0.0)), 1.0)
    n_safe = jnp.maximum(n_match, 1.0)
    return MatchResult(
        delta=delta,
        fitness=sum_d2_all / n_src,
        inlier_rms=jnp.sqrt(sum_d2 / n_safe),
        matched_frac=n_match / n_src,
        converged=last_upd < tol,
        mahal_rmse=jnp.sqrt(sum_mahal / n_safe),
        degenerate=degenerate,
        hessian=H_last,
    )
