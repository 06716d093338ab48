"""Unit tests for SE(2)/SO(2)/SE(3)/SO(3) — closed forms + jax.jacfwd checks.

The reference had zero tests (SURVEY.md §4); these guard the layer that its
graph.hpp/scanner.hpp got wrong (compose drops translation, atan vs atan2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphslam.geometry import se2, se3, so2, so3

KEY = jax.random.PRNGKey(0)


def rand_se2(key, shape=()):
    xyt = jax.random.normal(key, (*shape, 3))
    return xyt.at[..., 2].set(so2.wrap(2.0 * xyt[..., 2]))


def rand_se3(key, shape=()):
    k1, k2 = jax.random.split(key)
    w = jax.random.normal(k1, (*shape, 3))
    t = jax.random.normal(k2, (*shape, 3))
    return se3.make(so3.exp(w), t)


class TestSO2:
    def test_wrap(self):
        assert np.allclose(np.abs(so2.wrap(jnp.array(3 * np.pi))), np.pi, atol=1e-6)
        assert np.allclose(so2.wrap(jnp.array(2 * np.pi + 0.3)), 0.3, atol=1e-5)
        assert np.allclose(so2.wrap(jnp.array(-0.1)), -0.1, atol=1e-7)

    def test_rotate_matches_matrix(self):
        theta = jnp.array(0.7)
        v = jnp.array([1.0, 2.0])
        assert np.allclose(so2.rotate(theta, v), so2.rotmat(theta) @ v, atol=1e-6)


class TestSE2:
    def test_compose_identity(self):
        p = rand_se2(KEY, (5,))
        assert np.allclose(se2.compose(p, se2.identity((5,))), p, atol=1e-6)
        assert np.allclose(se2.compose(se2.identity((5,)), p), p, atol=1e-6)

    def test_compose_keeps_base_translation(self):
        # Regression vs the reference bug (graph.hpp:37-38): composing with a
        # pure rotation must preserve the base translation.
        base = jnp.array([3.0, 4.0, 0.5])
        rot = jnp.array([0.0, 0.0, 0.3])
        out = se2.compose(base, rot)
        assert np.allclose(out[:2], base[:2], atol=1e-6)

    def test_inverse(self):
        p = rand_se2(KEY, (7,))
        assert np.allclose(
            se2.compose(p, se2.inverse(p)), jnp.zeros((7, 3)), atol=1e-5
        )

    def test_between(self):
        k1, k2 = jax.random.split(KEY)
        a, b = rand_se2(k1, (4,)), rand_se2(k2, (4,))
        assert np.allclose(se2.compose(a, se2.between(a, b)), b, atol=1e-5)

    def test_exp_log_roundtrip(self):
        xi = jax.random.normal(KEY, (20, 3))
        assert np.allclose(se2.log(se2.exp(xi)), xi, atol=1e-5)

    def test_exp_log_small_angle(self):
        xi = jnp.array([[0.1, -0.2, 1e-9], [0.0, 0.0, 0.0]])
        assert np.allclose(se2.log(se2.exp(xi)), xi, atol=1e-7)

    def test_exp_matches_matrix_exponential(self):
        xi = jnp.array([0.3, -0.5, 0.9])
        # Matrix form of se(2) generator
        G = jnp.array([[0.0, -xi[2], xi[0]], [xi[2], 0.0, xi[1]], [0.0, 0.0, 0.0]])
        M = jax.scipy.linalg.expm(G)
        P = se2.matrix(se2.exp(xi))
        assert np.allclose(P, M, atol=1e-5)

    def test_adjoint_property(self):
        # p * Exp(xi) == Exp(Ad_p xi) * p
        p = rand_se2(KEY)
        xi = jnp.array([0.1, 0.2, -0.15])
        lhs = se2.compose(p, se2.exp(xi))
        rhs = se2.compose(se2.exp(se2.adjoint(p) @ xi), p)
        assert np.allclose(lhs, rhs, atol=1e-5)

    def test_transform(self):
        p = jnp.array([1.0, 2.0, jnp.pi / 2])
        pts = jnp.array([[1.0, 0.0], [0.0, 1.0]])
        out = se2.transform(p, pts)
        # R(pi/2)(1,0)+(1,2) = (1,3); R(pi/2)(0,1)+(1,2) = (0,2)
        assert np.allclose(out, jnp.array([[1.0, 3.0], [0.0, 2.0]]), atol=1e-5)


class TestSO3:
    def test_exp_log_roundtrip(self):
        w = jax.random.normal(KEY, (50, 3))
        # Rotation vectors only round-trip for |w| < pi (log is canonical).
        norm = jnp.linalg.norm(w, axis=-1, keepdims=True)
        w = w / norm * (norm % (0.95 * jnp.pi))
        assert np.allclose(so3.log(so3.exp(w)), w, atol=1e-4)

    def test_log_grad_at_identity(self):
        # The factor residual differentiates Log at/near the identity; the
        # Jacobian there must be finite and equal I (d Log(Exp(d))/dd = I).
        J = jax.jacfwd(lambda d: so3.log(so3.exp(d)))(jnp.zeros(3))
        assert np.all(np.isfinite(J))
        assert np.allclose(J, np.eye(3), atol=1e-5)

    def test_exp_log_small(self):
        w = jnp.array([[1e-8, 0.0, 0.0], [0.0, 0.0, 0.0]])
        assert np.allclose(so3.log(so3.exp(w)), w, atol=1e-9)

    def test_exp_log_near_pi(self):
        axis = jnp.array([1.0, 2.0, 3.0])
        axis = axis / jnp.linalg.norm(axis)
        w = axis * (jnp.pi - 1e-3)
        w2 = so3.log(so3.exp(w))
        # f32 floor: 1+cos(theta) ~ 5e-7 is at eps(1.0) resolution, so the
        # recovered angle/axis near pi carry ~sqrt(eps) error.
        assert np.allclose(w2, w, atol=5e-3)

    def test_orthonormal(self):
        R = so3.exp(jax.random.normal(KEY, (10, 3)))
        RtR = jnp.swapaxes(R, -1, -2) @ R
        assert np.allclose(RtR, jnp.broadcast_to(jnp.eye(3), (10, 3, 3)), atol=1e-5)

    def test_left_jacobian_numeric(self):
        w = jnp.array([0.3, -0.2, 0.5])
        # d/d eps log-linearization: Exp(w + J_l^-1 ... ) — check with jacfwd of
        # exp composed with log around w: J_l(w) = d Exp(w+d)/dd in the sense
        # Exp(w + dw) ~ Exp(J_l dw) Exp(w)
        def f(dw):
            return so3.log(so3.exp(w + dw) @ so3.exp(w).T)

        J = jax.jacfwd(f)(jnp.zeros(3))
        assert np.allclose(J, so3.left_jacobian(w), atol=1e-4)

    def test_left_jacobian_inv(self):
        w = jax.random.normal(KEY, (5, 3))
        J = so3.left_jacobian(w)
        Jinv = so3.left_jacobian_inv(w)
        assert np.allclose(J @ Jinv, jnp.broadcast_to(jnp.eye(3), (5, 3, 3)), atol=1e-5)

    def test_normalize(self):
        R = so3.exp(jax.random.normal(KEY, (4, 3)))
        noisy = R + 1e-3 * jax.random.normal(KEY, (4, 3, 3))
        Rn = so3.normalize(so3.normalize(noisy))
        assert np.allclose(
            jnp.swapaxes(Rn, -1, -2) @ Rn, jnp.broadcast_to(jnp.eye(3), (4, 3, 3)),
            atol=1e-5,
        )


class TestSE3:
    def test_compose_inverse(self):
        p = rand_se3(KEY, (6,))
        ident = se3.compose(p, se3.inverse(p))
        assert np.allclose(se3.rot(ident), jnp.broadcast_to(jnp.eye(3), (6, 3, 3)), atol=1e-5)
        assert np.allclose(se3.trans(ident), jnp.zeros((6, 3)), atol=1e-5)

    def test_between(self):
        k1, k2 = jax.random.split(KEY)
        a, b = rand_se3(k1, (4,)), rand_se3(k2, (4,))
        assert np.allclose(se3.compose(a, se3.between(a, b)), b, atol=1e-5)

    def test_exp_log_roundtrip(self):
        xi = 0.8 * jax.random.normal(KEY, (30, 6))
        assert np.allclose(se3.log(se3.exp(xi)), xi, atol=1e-4)

    def test_exp_matches_matrix_exponential(self):
        xi = jnp.array([0.2, -0.1, 0.4, 0.3, 0.2, -0.5])
        rho, phi = xi[:3], xi[3:]
        G = jnp.zeros((4, 4))
        G = G.at[:3, :3].set(so3.hat(phi)).at[:3, 3].set(rho)
        M = jax.scipy.linalg.expm(G)
        p = se3.exp(xi)
        assert np.allclose(se3.rot(p), M[:3, :3], atol=1e-5)
        assert np.allclose(se3.trans(p), M[:3, 3], atol=1e-5)

    def test_adjoint_property(self):
        p = rand_se3(KEY)
        xi = 0.3 * jnp.arange(1.0, 7.0) / 6.0
        lhs = se3.compose(p, se3.exp(xi))
        rhs = se3.compose(se3.exp(se3.adjoint(p) @ xi), p)
        assert np.allclose(lhs, rhs, atol=1e-4)

    def test_transform(self):
        p = rand_se3(KEY)
        pts = jax.random.normal(KEY, (11, 3))
        expected = (se3.rot(p) @ pts.T).T + se3.trans(p)
        assert np.allclose(se3.transform(p, pts), expected, atol=1e-5)


class TestGroupLaws:
    def test_se2_associativity(self):
        k1, k2, k3 = jax.random.split(KEY, 3)
        a, b, c = rand_se2(k1, (6,)), rand_se2(k2, (6,)), rand_se2(k3, (6,))
        lhs = se2.compose(se2.compose(a, b), c)
        rhs = se2.compose(a, se2.compose(b, c))
        assert np.allclose(lhs[:, :2], rhs[:, :2], atol=1e-5)
        assert np.allclose(so2.wrap(lhs[:, 2] - rhs[:, 2]), 0.0, atol=1e-5)

    def test_se3_associativity(self):
        k1, k2, k3 = jax.random.split(KEY, 3)
        a, b, c = rand_se3(k1, (6,)), rand_se3(k2, (6,)), rand_se3(k3, (6,))
        lhs = se3.compose(se3.compose(a, b), c)
        rhs = se3.compose(a, se3.compose(b, c))
        assert np.allclose(lhs, rhs, atol=1e-4)

    def test_inverse_of_compose(self):
        k1, k2 = jax.random.split(KEY)
        a, b = rand_se3(k1, (5,)), rand_se3(k2, (5,))
        lhs = se3.inverse(se3.compose(a, b))
        rhs = se3.compose(se3.inverse(b), se3.inverse(a))
        assert np.allclose(lhs, rhs, atol=1e-4)

    def test_exp_jacobian_identity_at_zero(self):
        J2 = jax.jacfwd(se2.exp)(jnp.zeros(3))
        assert np.allclose(J2, np.eye(3), atol=1e-6)
        J3 = jax.jacfwd(lambda d: se3.log(se3.exp(d)))(jnp.zeros(6))
        assert np.allclose(J3, np.eye(6), atol=1e-5)

    def test_so3_project_recovers_rotation(self):
        R = so3.exp(jax.random.normal(KEY, (8, 3)))
        noisy = 1.7 * R + 0.3 * jax.random.normal(KEY, (8, 3, 3))
        P = so3.project(noisy)
        PtP = jnp.swapaxes(P, -1, -2) @ P
        assert np.allclose(PtP, jnp.broadcast_to(jnp.eye(3), (8, 3, 3)), atol=1e-4)
        assert np.allclose(jnp.linalg.det(P), 1.0, atol=1e-4)


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
