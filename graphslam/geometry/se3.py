"""SE(3): rigid transforms stored as a dict-free flat (..., 12) array.

Layout: [:9] row-major 3x3 rotation, [9:12] translation. A single flat array
(instead of a (R, t) tuple) keeps the pose-graph state one contiguous buffer
— friendlier to donation, sharding, and scatter updates in the online
pipeline. Helpers `rot`/`trans` views are cheap reshapes.

Tangents are (..., 6) arrays [rho (3 trans), phi (3 rot)] with the right
retraction x * Exp(xi), matching GTSAM's Pose3 convention so its optimizer
behavior (and test numbers) transfer.
"""

from __future__ import annotations

import jax.numpy as jnp

from graphslam.geometry import so3

DIM = 12  # storage dim
TANGENT_DIM = 6


def rot(p: jnp.ndarray) -> jnp.ndarray:
    return p[..., :9].reshape(*p.shape[:-1], 3, 3)

def trans(p: jnp.ndarray) -> jnp.ndarray:
    return p[..., 9:12]


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([R.reshape(*R.shape[:-2], 9), t], axis=-1)


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return make(so3.identity(batch_shape, dtype), jnp.zeros((*batch_shape, 3), dtype))


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    Ra, ta = rot(a), trans(a)
    Rb, tb = rot(b), trans(b)
    return make(Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta)


def inverse(a: jnp.ndarray) -> jnp.ndarray:
    Ra, ta = rot(a), trans(a)
    RaT = jnp.swapaxes(Ra, -1, -2)
    return make(RaT, -(RaT @ ta[..., None])[..., 0])


def between(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a^-1 * b."""
    Ra, ta = rot(a), trans(a)
    RaT = jnp.swapaxes(Ra, -1, -2)
    Rb, tb = rot(b), trans(b)
    return make(RaT @ Rb, (RaT @ (tb - ta)[..., None])[..., 0])


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) -> SE(3). xi = [rho, phi]; t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3.exp(phi)
    t = (so3.left_jacobian(phi) @ rho[..., None])[..., 0]
    return make(R, t)


def log(p: jnp.ndarray) -> jnp.ndarray:
    phi = so3.log(rot(p))
    rho = (so3.left_jacobian_inv(phi) @ trans(p)[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def retract(p: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    return compose(p, exp(xi))


def local(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    return log(between(p, q))


def adjoint(p: jnp.ndarray) -> jnp.ndarray:
    """(..., 6, 6) adjoint: Ad_p = [[R, hat(t) R], [0, R]]."""
    R, t = rot(p), trans(p)
    tR = so3.hat(t) @ R
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def transform(p: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply pose p (..., 12) to points (..., N, 3)."""
    R, t = rot(p), trans(p)
    return pts @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def renormalize(p: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation part (drift control for long runs)."""
    return make(so3.normalize(rot(p)), trans(p))


def _Q_matrix(rho: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    """Barfoot's Q(rho, phi) — the translation-rotation coupling block of the
    SE(3) left Jacobian (State Estimation for Robotics, eq. 7.86). Series-
    safe: every theta-ratio switches to its Taylor form below 0.7 rad, where
    the closed forms lose float32 digits to cancellation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 0.7
    ts = jnp.where(small, 1.0, theta)

    # c1 = (theta - sin)/theta^3
    c1 = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (ts - jnp.sin(ts)) / ts**3,
    )
    # c2 = (1 - theta^2/2 - cos)/theta^4  (note: negative)
    c2 = jnp.where(
        small,
        -1.0 / 24.0 + theta2 / 720.0 - theta2 * theta2 / 40320.0,
        (1.0 - ts * ts / 2.0 - jnp.cos(ts)) / ts**4,
    )
    # c3i = (theta - sin - theta^3/6)/theta^5  (negative)
    c3i = jnp.where(
        small,
        -1.0 / 120.0 + theta2 / 5040.0 - theta2 * theta2 / 362880.0,
        (ts - jnp.sin(ts) - ts**3 / 6.0) / ts**5,
    )

    rx = so3.hat(rho)
    px = so3.hat(phi)
    pxrx = px @ rx
    rxpx = rx @ px
    pxrxpx = pxrx @ px

    t1 = 0.5 * rx
    t2 = c1[..., None, None] * (pxrx + rxpx + pxrxpx)
    t3 = -c2[..., None, None] * (px @ pxrx + rxpx @ px - 3.0 * pxrxpx)
    t4 = -0.5 * (c2 - 3.0 * c3i)[..., None, None] * (pxrxpx @ px + px @ pxrxpx)
    return t1 + t2 + t3 + t4


def left_jacobian_inv(xi: jnp.ndarray) -> jnp.ndarray:
    """Inverse SE(3) left Jacobian (..., 6, 6) in [rho, phi] block order.

    Jl = [[J, Q], [0, J]] with J the SO(3) left Jacobian, so
    Jl^{-1} = [[J^{-1}, -J^{-1} Q J^{-1}], [0, J^{-1}]]. Validated against
    jax.jacfwd in tests/test_factors.py.
    """
    rho, phi = xi[..., :3], xi[..., 3:6]
    Jinv = so3.left_jacobian_inv(phi)
    Q = _Q_matrix(rho, phi)
    TR = -Jinv @ Q @ Jinv
    zero = jnp.zeros_like(Jinv)
    top = jnp.concatenate([Jinv, TR], axis=-1)
    bottom = jnp.concatenate([zero, Jinv], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def right_jacobian_inv(xi: jnp.ndarray) -> jnp.ndarray:
    """Inverse SE(3) right Jacobian: Jr^{-1}(xi) = Jl^{-1}(-xi)."""
    return left_jacobian_inv(-xi)
