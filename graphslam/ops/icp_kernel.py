"""One GICP IRLS iteration as one GPU kernel (Pallas, Triton route).

For the current SE(2) estimate `delta`, each program takes BLOCK_P source
points, transforms them, and streams the target scan in BLOCK_Q-point chunks
keeping a running nearest-valid-target min/argmin (exact coordinate
differences; ties keep the lowest index, as `jnp.argmin` does). It then loads
the matched target point and its surfel covariance by index, forms the 2x2
plane-to-plane Mahalanobis weight, and reduces its rows' share of the 3-dof
normal equations. Each program writes 13 partial sums into its own row of a
(G, 16) output:

    [H00, H01, H11, H02, H12, H22, g0, g1, g2,
     sum_d2_all, sum_d2_gated, n_match, sum_mahal, 0, 0, 0]

and XLA sums the rows, so no carry crosses programs. Neither the (P, Q)
distance matrix nor any per-point intermediate reaches device memory.

`fused_icp_iteration_reference` is the plain jnp version of the same math.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_P = 16    # source points per program
BLOCK_Q = 128   # target points per streamed chunk
OUT_LANES = 16
_BIG = 3.4e38   # distance of an invalid target


def _kernel(pose_ref, sx_ref, sy_ref, smask_ref, cs11_ref, cs12_ref, cs22_ref,
            tx_ref, ty_ref, tvalid_ref, ct11_ref, ct12_ref, ct22_ref, out_ref,
            *, n_chunks: int, max_corr2: float, eps: float):
    c, s = pose_ref[0], pose_ref[1]
    px, py = sx_ref[...], sy_ref[...]                      # (BP,)
    mx = c * px - s * py + pose_ref[2]
    my = s * px + c * py + pose_ref[3]
    jx = -s * px - c * py                                  # dR/dtheta @ p
    jy = c * px - s * py

    def chunk(k, carry):
        best_d2, best_idx = carry
        sl = pl.ds(k * BLOCK_Q, BLOCK_Q)
        dx = mx[:, None] - tx_ref[sl][None, :]             # (BP, BQ)
        dy = my[:, None] - ty_ref[sl][None, :]
        d2 = dx * dx + dy * dy
        d2 = jnp.where(tvalid_ref[sl][None, :] != 0, d2, _BIG)
        cmin = jnp.min(d2, axis=1)
        cidx = jnp.argmin(d2, axis=1).astype(jnp.int32) + k * BLOCK_Q
        better = cmin < best_d2                             # strict: first wins
        return jnp.where(better, cmin, best_d2), jnp.where(better, cidx, best_idx)

    min_d2, nn = jax.lax.fori_loop(
        0, n_chunks, chunk,
        (jnp.full((BLOCK_P,), _BIG, jnp.float32), jnp.zeros((BLOCK_P,), jnp.int32)),
    )

    qx, qy = tx_ref[nn], ty_ref[nn]                        # matched target
    smask = smask_ref[...] != 0
    w = smask & (min_d2 < _BIG * 0.5) & (min_d2 <= max_corr2)
    wf = jnp.where(w, 1.0, 0.0)
    wall = jnp.where(smask, 1.0, 0.0)

    # R Cs R^T (upper entries) + target covariance + eps I, inverted in
    # closed form.
    a, b, d = cs11_ref[...], cs12_ref[...], cs22_ref[...]
    c11 = ct11_ref[nn] + (c * c * a - 2 * c * s * b + s * s * d) + eps
    c12 = ct12_ref[nn] + (c * s * (a - d) + (c * c - s * s) * b)
    c22 = ct22_ref[nn] + (s * s * a + 2 * c * s * b + c * c * d) + eps
    det = c11 * c22 - c12 * c12
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    m11, m12, m22 = c22 / det, -c12 / det, c11 / det

    ex, ey = qx - mx, qy - my
    me1 = m11 * ex + m12 * ey
    me2 = m12 * ex + m22 * ey
    d2c = jnp.minimum(min_d2, 1e9)
    sums = [
        wf * m11,
        wf * m12,
        wf * m22,
        wf * (m11 * jx + m12 * jy),
        wf * (m12 * jx + m22 * jy),
        wf * (jx * jx * m11 + 2.0 * jx * jy * m12 + jy * jy * m22),
        wf * me1,
        wf * me2,
        wf * (jx * me1 + jy * me2),
        wall * d2c,
        wf * d2c,
        wf,
        wf * (ex * me1 + ey * me2),
    ]
    lane = jnp.arange(OUT_LANES, dtype=jnp.int32)
    row = jnp.zeros((OUT_LANES,), jnp.float32)
    for i, v in enumerate(sums):
        row = row + jnp.where(lane == i, jnp.sum(v), 0.0)
    out_ref[...] = row


def _columns(pts, mask, C, n: int):
    """[x, y, mask, c11, c12, c22] as 1-D arrays zero-padded to length n."""
    f32 = jnp.float32
    cols = (pts[:, 0].astype(f32), pts[:, 1].astype(f32), mask.astype(jnp.int32),
            C[:, 0, 0].astype(f32), C[:, 0, 1].astype(f32), C[:, 1, 1].astype(f32))
    return [jnp.pad(x, (0, n - x.shape[0])) for x in cols]


def _unpack(acc: jnp.ndarray):
    H = jnp.array(
        [[acc[0], acc[1], acc[3]],
         [acc[1], acc[2], acc[4]],
         [acc[3], acc[4], acc[5]]]
    )
    return H, acc[6:9], acc[9:13]


@partial(jax.jit, static_argnames=("max_corr2", "eps", "interpret"))
def fused_icp_iteration(
    delta: jnp.ndarray,      # (3,) current SE(2) estimate, source -> target
    src: jnp.ndarray,        # (P, 2) source points (sensor frame)
    src_mask: jnp.ndarray,   # (P,)
    Cs: jnp.ndarray,         # (P, 2, 2) source surfel covariances
    tgt: jnp.ndarray,        # (Q, 2)
    tgt_valid: jnp.ndarray,  # (Q,)
    Ct: jnp.ndarray,         # (Q, 2, 2) target surfel covariances
    *,
    max_corr2: float,
    eps: float,
    interpret: bool = False,
):
    """Returns (H (3,3), g (3,), stats (4,)): the iteration's normal
    equations and [sum_d2_all, sum_d2_gated, n_match, sum_mahal].

    Compiles for a CUDA device only; `interpret=True` runs the kernel body
    through the Pallas interpreter on any backend (tests)."""
    P, Q = src.shape[0], tgt.shape[0]
    G = pl.cdiv(P, BLOCK_P)
    Pp, Qp = G * BLOCK_P, pl.cdiv(Q, BLOCK_Q) * BLOCK_Q
    f32 = jnp.float32
    pose = jnp.stack(
        [jnp.cos(delta[2]), jnp.sin(delta[2]), delta[0], delta[1]]
    ).astype(f32)
    src_cols = _columns(src, src_mask, Cs, Pp)
    tgt_cols = _columns(tgt, tgt_valid, Ct, Qp)

    src_spec = pl.BlockSpec((BLOCK_P,), lambda i: (i,))
    tgt_spec = pl.BlockSpec((Qp,), lambda i: (0,))
    out = pl.pallas_call(
        partial(_kernel, n_chunks=Qp // BLOCK_Q, max_corr2=float(max_corr2),
                eps=float(eps)),
        grid=(G,),
        in_specs=[pl.BlockSpec((4,), lambda i: (0,))]
        + [src_spec] * 6 + [tgt_spec] * 6,
        out_specs=pl.BlockSpec((None, OUT_LANES), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((G, OUT_LANES), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="gicp_irls_iteration",
    )(pose, *src_cols, *tgt_cols)
    H, g, stats = _unpack(jnp.sum(out, axis=0))
    return H.astype(delta.dtype), g.astype(delta.dtype), stats.astype(delta.dtype)


def fused_icp_iteration_reference(
    delta, src, src_mask, Cs, tgt, tgt_valid, Ct, max_corr2, eps
):
    """Plain jnp version of `fused_icp_iteration` with identical semantics."""
    c, s = jnp.cos(delta[2]), jnp.sin(delta[2])
    px, py = src[:, 0], src[:, 1]
    mx = c * px - s * py + delta[0]
    my = s * px + c * py + delta[1]
    jx, jy = -s * px - c * py, c * px - s * py

    dx = mx[:, None] - tgt[None, :, 0]
    dy = my[:, None] - tgt[None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = jnp.where(tgt_valid[None, :], d2, jnp.asarray(_BIG, d2.dtype))
    nn = jnp.argmin(d2, axis=1)
    min_d2 = jnp.take_along_axis(d2, nn[:, None], axis=1)[:, 0]
    q = tgt[nn]
    Ctn = Ct[nn]

    w = src_mask & (min_d2 < _BIG * 0.5) & (min_d2 <= max_corr2)
    wf = w.astype(d2.dtype)
    wall = src_mask.astype(d2.dtype)

    a, b, d = Cs[:, 0, 0], Cs[:, 0, 1], Cs[:, 1, 1]
    c11 = Ctn[:, 0, 0] + (c * c * a - 2 * c * s * b + s * s * d) + eps
    c12 = Ctn[:, 0, 1] + (c * s * (a - d) + (c * c - s * s) * b)
    c22 = Ctn[:, 1, 1] + (s * s * a + 2 * c * s * b + c * c * d) + eps
    det = c11 * c22 - c12 * c12
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    m11, m12, m22 = c22 / det, -c12 / det, c11 / det

    ex, ey = q[:, 0] - mx, q[:, 1] - my
    me1 = m11 * ex + m12 * ey
    me2 = m12 * ex + m22 * ey
    d2c = jnp.minimum(min_d2, 1e9)
    acc = jnp.stack([
        jnp.sum(wf * m11),
        jnp.sum(wf * m12),
        jnp.sum(wf * m22),
        jnp.sum(wf * (m11 * jx + m12 * jy)),
        jnp.sum(wf * (m12 * jx + m22 * jy)),
        jnp.sum(wf * (jx * jx * m11 + 2 * jx * jy * m12 + jy * jy * m22)),
        jnp.sum(wf * me1),
        jnp.sum(wf * me2),
        jnp.sum(wf * (jx * me1 + jy * me2)),
        jnp.sum(wall * d2c),
        jnp.sum(wf * d2c),
        jnp.sum(wf),
        jnp.sum(wf * (ex * me1 + ey * me2)),
    ])
    return _unpack(acc)
