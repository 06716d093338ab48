"""Odometry motion model: twist integration + time-indexed ring buffer.

The reference's odometry node was dead code — its integration body was
commented out and the executable never built (odometry.cpp:139-206,
CMakeLists.txt:21-23; SURVEY.md §3.4). This implements the *intended*
semantics: integrate /cmd_vel twists into a pose with a motion-scaled
covariance (k_disp_disp/k_rot_disp/k_rot_rot model, odometry.cpp:23), keep a
fixed-depth ring buffer of stamped poses (odometry.cpp:74's 1000-deep deque),
and serve relative-pose deltas over a time interval (odometry.cpp:84-116's
OdometryBuffer service — with nearest-timestamp lookup instead of the
reference's whole-second integer matching bug).
"""

from __future__ import annotations

import jax.numpy as jnp

from graphslam.config import FrontendConfig
from graphslam.frontend.keyframes import motion_covariance
from graphslam.geometry import se2
from graphslam.pytree import pytree_dataclass

BUFFER_DEPTH = 1000  # odometry.cpp:74


@pytree_dataclass
class OdometryBuffer:
    times: jnp.ndarray   # (B,)
    poses: jnp.ndarray   # (B, 3)
    covs: jnp.ndarray    # (B, 3, 3) body-frame covariance at each stamp
    valid: jnp.ndarray   # (B,)
    head: jnp.ndarray    # () int32 next write slot
    pose: jnp.ndarray    # (3,) current integrated pose
    cov: jnp.ndarray     # (3, 3) accumulated covariance


def init_buffer(depth: int = BUFFER_DEPTH, dtype=jnp.float32) -> OdometryBuffer:
    return OdometryBuffer(
        times=jnp.full((depth,), -jnp.inf, dtype),
        poses=jnp.zeros((depth, 3), dtype),
        covs=jnp.zeros((depth, 3, 3), dtype),
        valid=jnp.zeros((depth,), bool),
        head=jnp.int32(0),
        pose=jnp.zeros((3,), dtype),
        cov=jnp.zeros((3, 3), dtype),
    )


def integrate_twist(
    buf: OdometryBuffer,
    twist: jnp.ndarray,  # (3,) [vx, vy, omega] body frame
    dt: jnp.ndarray,
    t: jnp.ndarray,
    cfg: FrontendConfig = FrontendConfig(),
) -> OdometryBuffer:
    """One integration tick (the odometry.cpp:139-206 loop body, enabled)."""
    delta = twist * dt
    new_pose = se2.compose(buf.pose, delta)
    # Covariance transported through the motion and grown by the step model:
    # C_{t+1} = Ad(delta)^{-1} C_t Ad(delta)^{-T} + Q_step, with Ad the GROUP
    # adjoint of the relative pose applied in `compose` above (the adjoint is
    # a homomorphism, so interval transports compose exactly — see
    # query_interval).
    Ad_inv = se2.adjoint(se2.inverse(delta))
    # f32-exact products: a default-precision dot may run in TF32 or bf16,
    # which can leave the transported covariance indefinite.
    hi = jnp.einsum(
        "ij,jk->ik", Ad_inv, buf.cov, precision="highest"
    )
    grown = jnp.einsum(
        "ij,kj->ik", hi, Ad_inv, precision="highest"
    ) + motion_covariance(delta, cfg)
    depth = buf.times.shape[0]
    h = buf.head % depth
    return buf.replace(
        times=buf.times.at[h].set(t),
        poses=buf.poses.at[h].set(new_pose),
        covs=buf.covs.at[h].set(grown),
        valid=buf.valid.at[h].set(True),
        head=buf.head + 1,
        pose=new_pose,
        cov=grown,
    )


def _entry_at(buf: OdometryBuffer, t: jnp.ndarray):
    """(pose, covariance) at the buffered timestamp nearest to t."""
    dt = jnp.where(buf.valid, jnp.abs(buf.times - t), jnp.inf)
    k = jnp.argmin(dt)
    return buf.poses[k], buf.covs[k]


def query_interval(
    buf: OdometryBuffer,
    t_start: jnp.ndarray,
    t_end: jnp.ndarray,
    cfg: FrontendConfig = FrontendConfig(),
):
    """Relative pose and TRANSPORTED covariance between the buffered poses
    nearest to t_start and t_end — the OdometryBuffer.srv contract
    (odometry.cpp:84-116's intended semantics).

    The per-entry covariances follow C_b = Ad(delta)^{-1} C_a Ad(delta)^{-T}
    + Q_ab (integrate_twist), so the noise accumulated strictly inside the
    interval is recovered exactly:  Q_ab = C_b - Ad(D)^{-1} C_a Ad(D)^{-T}
    with D = between(a, b). Symmetrized with a small PSD floor against f32
    rounding."""
    a, Ca = _entry_at(buf, t_start)
    b, Cb = _entry_at(buf, t_end)
    delta = se2.between(a, b)
    Ad_inv = se2.adjoint(se2.inverse(delta))
    hi = jnp.einsum("ij,jk->ik", Ad_inv, Ca, precision="highest")
    Q = Cb - jnp.einsum("ij,kj->ik", hi, Ad_inv, precision="highest")
    Q = 0.5 * (Q + Q.T)
    # PSD floor: rounding (or a query straddling the ring-buffer overwrite
    # horizon) can leave a slightly indefinite difference.
    eigmin = jnp.min(jnp.linalg.eigvalsh(Q))
    Q = Q + (jnp.maximum(0.0, -eigmin) + 1e-12) * jnp.eye(3, dtype=Q.dtype)
    return delta, Q
