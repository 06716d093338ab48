"""SE(2): planar rigid transforms stored as (..., 3) arrays [x, y, theta].

This is the state type of the 2D pose graph. It replaces gtsam::Pose2 and
fixes the reference's compose bug (graph.hpp:37-38 drops the base
translation) and atan bug (scanner.hpp:59).

Tangent vectors are (..., 3) arrays [vx, vy, omega] in the BODY frame; the
retraction used by the optimizer is the right action  x <- x * Exp(xi).

All functions broadcast over leading batch dims and are jit/vmap/grad-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

from graphslam.geometry import so2


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros((*batch_shape, 3), dtype=dtype)


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a * b: apply b in a's frame. (Correct version of graph.hpp:30-43.)"""
    t = a[..., :2] + so2.rotate(a[..., 2], b[..., :2])
    theta = so2.wrap(a[..., 2] + b[..., 2])
    return jnp.concatenate([t, theta[..., None]], axis=-1)


def inverse(a: jnp.ndarray) -> jnp.ndarray:
    t = -so2.unrotate(a[..., 2], a[..., :2])
    return jnp.concatenate([t, -a[..., 2:3]], axis=-1)


def between(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a^-1 * b: the relative transform taking frame a to frame b."""
    dt = so2.unrotate(a[..., 2], b[..., :2] - a[..., :2])
    dtheta = so2.wrap(b[..., 2] - a[..., 2])
    return jnp.concatenate([dt, dtheta[..., None]], axis=-1)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map se(2) -> SE(2). xi = [vx, vy, omega]."""
    v, w = xi[..., :2], xi[..., 2]
    # V(w) = [[a, -b], [b, a]] with a = sin w / w, b = (1 - cos w)/w.
    # Half-angle forms avoid the 1-cos cancellation in float32.
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    half = w_safe / 2.0
    a = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(w_safe) / w_safe)
    b = jnp.where(small, w / 2.0 - w**3 / 24.0, 2.0 * jnp.sin(half) ** 2 / w_safe)
    x = a * v[..., 0] - b * v[..., 1]
    y = b * v[..., 0] + a * v[..., 1]
    return jnp.stack([x, y, so2.wrap(w)], axis=-1)


def log(p: jnp.ndarray) -> jnp.ndarray:
    """Log map SE(2) -> se(2)."""
    t, w = p[..., :2], so2.wrap(p[..., 2])
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    half = w / 2.0
    # V^{-1} = [[A, B], [-B, A]], A = w sin w / (2 (1 - cos w)) = (w/2)·cot(w/2)
    # (half-angle form: no 1-cos cancellation), B = w/2.
    half_safe = w_safe / 2.0
    A = jnp.where(
        small,
        1.0 - w * w / 12.0,
        half_safe * jnp.cos(half_safe) / jnp.sin(half_safe),
    )
    vx = A * t[..., 0] + half * t[..., 1]
    vy = -half * t[..., 0] + A * t[..., 1]
    return jnp.stack([vx, vy, w], axis=-1)


def retract(p: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Right retraction p * Exp(xi) — the optimizer's manifold update."""
    return compose(p, exp(xi))


def local(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Inverse retraction: Log(p^-1 q)."""
    return log(between(p, q))


def adjoint(p: jnp.ndarray) -> jnp.ndarray:
    """Adjoint matrix (..., 3, 3): Ad_p xi transports tangents p-frame->world."""
    c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
    x, y = p[..., 0], p[..., 1]
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    row0 = jnp.stack([c, -s, y], axis=-1)
    row1 = jnp.stack([s, c, -x], axis=-1)
    row2 = jnp.stack([zero, zero, one], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def _V_terms(w: jnp.ndarray):
    """a = sin w / w, b = (1-cos w)/w and their w-derivatives (series-safe)."""
    small = jnp.abs(w) < 1e-4
    ws = jnp.where(small, 1.0, w)
    half = ws / 2.0
    a = jnp.where(small, 1.0 - w * w / 6.0, jnp.sin(ws) / ws)
    b = jnp.where(small, w / 2.0 - w**3 / 24.0, 2.0 * jnp.sin(half) ** 2 / ws)
    da = jnp.where(
        small, -w / 3.0 + w**3 / 30.0, (ws * jnp.cos(ws) - jnp.sin(ws)) / (ws * ws)
    )
    db = jnp.where(
        small,
        0.5 - w * w / 8.0,
        (ws * jnp.sin(ws) - 2.0 * jnp.sin(half) ** 2) / (ws * ws),
    )
    return a, b, da, db


def left_jacobian_inv(xi: jnp.ndarray) -> jnp.ndarray:
    """Inverse SE(2) left Jacobian, (..., 3, 3) — closed form.

    Jl(xi) = [[V(w), D(xi)], [0, 1]] with V from `exp` and
    D = V'(w) v - J V(w) v (J = 90-deg rotation), so
    Jl^{-1} = [[V^{-1}, -V^{-1} D], [0, 1]]. Validated against jax.jacfwd in
    tests/test_geometry.py.
    """
    v = xi[..., :2]
    w = xi[..., 2]
    a, b, da, db = _V_terms(w)
    # V v and V' v
    Vv_x = a * v[..., 0] - b * v[..., 1]
    Vv_y = b * v[..., 0] + a * v[..., 1]
    dVv_x = da * v[..., 0] - db * v[..., 1]
    dVv_y = db * v[..., 0] + da * v[..., 1]
    # D = V' v - J (V v); J (x, y) = (-y, x)
    D_x = dVv_x + Vv_y
    D_y = dVv_y - Vv_x
    # V^{-1} = [[A, B], [-B, A]] (same as in `log`)
    small = jnp.abs(w) < 1e-4
    ws = jnp.where(small, 1.0, w)
    halfs = ws / 2.0
    A = jnp.where(small, 1.0 - w * w / 12.0, halfs * jnp.cos(halfs) / jnp.sin(halfs))
    B = w / 2.0
    # -V^{-1} D
    E_x = -(A * D_x + B * D_y)
    E_y = -(-B * D_x + A * D_y)
    zero = jnp.zeros_like(w)
    one = jnp.ones_like(w)
    row0 = jnp.stack([A, B, E_x], axis=-1)
    row1 = jnp.stack([-B, A, E_y], axis=-1)
    row2 = jnp.stack([zero, zero, one], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def right_jacobian_inv(xi: jnp.ndarray) -> jnp.ndarray:
    """Inverse SE(2) right Jacobian: Jr^{-1}(xi) = Jl^{-1}(-xi)."""
    return left_jacobian_inv(-xi)


def transform(p: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply pose p (..., 3) to points pts (..., N, 2) in p's frame."""
    return so2.rotate(p[..., None, 2], pts) + p[..., None, :2]


def matrix(p: jnp.ndarray) -> jnp.ndarray:
    """Homogeneous (..., 3, 3) matrix form."""
    R = so2.rotmat(p[..., 2])
    t = p[..., :2, None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=p.dtype), (*p.shape[:-1], 1, 3)
    )
    return jnp.concatenate([top, bottom], axis=-2)
