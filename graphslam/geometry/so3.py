"""SO(3): 3D rotations stored as (..., 3, 3) rotation matrices.

Matrix storage (over quaternions): compose is a batched matmul, and the
optimizer only needs exp/log/compose. Tangents are (..., 3) rotation vectors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([zero, -z, y], axis=-1)
    row1 = jnp.stack([z, zero, -x], axis=-1)
    row2 = jnp.stack([-y, x, zero], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew matrix -> (..., 3) vector."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, series-safe near zero."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-6
    theta_safe = jnp.where(small, 1.0, theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta_safe) / theta_safe)
    # (1 - cos t)/t^2 = 2 sin^2(t/2)/t^2 — half-angle form avoids cancellation.
    b = jnp.where(
        small,
        0.5 - theta2 / 24.0,
        2.0 * jnp.sin(theta_safe / 2.0) ** 2 / (theta_safe * theta_safe),
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector from matrix.

    Differentiability matters here: the factor residual r = Log(z^-1 h) is
    differentiated by jacfwd and approaches Log(I) at convergence, so the
    gradient at (and near) the identity must be finite and exact. We write
    w = k(c) * vee(R - R^T)/2 with k = theta / sin(theta) expressed purely in
    c = cos(theta), using a Taylor series in u = 1 - c near the identity and
    the double-where trick so no branch ever produces a NaN tangent.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    w_skew = vee(R - jnp.swapaxes(R, -1, -2)) / 2.0  # = sin(theta) * axis

    near_id = c > 0.95  # theta < ~0.32: series in u is exact to f32 there
    near_pi = c < -0.99  # theta > ~3.0

    # k(c) = arccos(c)/sqrt(1-c^2); series 1 + u/3 + 2u^2/15 + ... near c=1.
    u = 1.0 - c
    c_safe = jnp.where(near_id | near_pi, 0.0, c)  # fake input keeps grads finite
    k_generic = jnp.arccos(c_safe) * jax.lax.rsqrt(jnp.maximum(1.0 - c_safe * c_safe, 1e-12))
    k_series = 1.0 + u / 3.0 + (2.0 / 15.0) * u * u + (2.0 / 35.0) * u * u * u
    k = jnp.where(near_id, k_series, k_generic)
    w_main = k[..., None] * w_skew

    # Near pi the vee part vanishes (sin theta -> 0): recover the axis from
    # the largest column of R + I instead. Not smooth at exactly pi — residuals
    # that large are outside any trust region anyway.
    v = 1.0 + c  # = 1 - cos(pi - theta) ~ (pi-theta)^2/2
    theta_pi = jnp.pi - jnp.sqrt(jnp.maximum(2.0 * v, 0.0)) * (1.0 + v / 12.0)
    Rp = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    col_norms2 = jnp.sum(Rp * Rp, axis=-2)
    kcol = jnp.argmax(col_norms2, axis=-1)
    axis_raw = jnp.take_along_axis(Rp, kcol[..., None, None], axis=-1)[..., 0]
    axis = axis_raw * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(axis_raw * axis_raw, axis=-1, keepdims=True), 1e-12)
    )
    sign = jnp.where(jnp.sum(axis * w_skew, axis=-1, keepdims=True) < 0.0, -1.0, 1.0)
    w_pi = theta_pi[..., None] * axis * sign

    return jnp.where(near_pi[..., None], w_pi, w_main)


def left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J_l(w) (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-6
    theta_safe = jnp.where(small, 1.0, theta)
    A = jnp.where(
        small,
        0.5 - theta2 / 24.0,
        2.0 * jnp.sin(theta_safe / 2.0) ** 2 / (theta_safe**2),
    )
    B = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta_safe - jnp.sin(theta_safe)) / (theta_safe**3),
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse of the SO(3) left Jacobian."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-6
    theta_safe = jnp.where(small, 1.0, theta)
    half = theta_safe / 2.0
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / (theta_safe**2),
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * (W @ W)


def normalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation back onto SO(3) (SVD-free Gram-Schmidt-ish:
    one Newton step of the polar decomposition — cheap and vmappable).
    Only valid for small perturbations; use `project` for arbitrary 3x3s."""
    # R <- R (3I - R^T R)/2 : quadratic convergence to the polar factor.
    RtR = jnp.swapaxes(R, -1, -2) @ R
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    return R @ (1.5 * eye - 0.5 * RtR)


def project(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation (Frobenius) to an arbitrary 3x3: SVD projection
    U diag(1, 1, det(U V^T)) V^T. Batched; used by chordal initialization
    where the linear estimate can be far from orthonormal."""
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones((*det.shape, 2), M.dtype), det[..., None]], axis=-1
    )
    return (U * D[..., None, :]) @ Vt
