"""Factor linearization tests: analytic SE(2) Jacobians vs forward-mode AD,
and the SE(2) inverse-Jacobian closed forms themselves."""

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.factors.linearize import linearize_edges, linearize_priors
from graphslam.geometry import se2

KEY = jax.random.PRNGKey(42)


def rand_pose(key, shape=()):
    x = jax.random.normal(key, (*shape, 3))
    return x.at[..., 2].set(se2.so2.wrap(x[..., 2])) if hasattr(se2, "so2") else x


class TestSE2Jacobians:
    def test_left_jacobian_inv_vs_numeric(self):
        # Jl is defined by Exp(xi + d) ~ Exp(Jl d) Exp(xi); check Jl^-1 Jl = I
        # with Jl from jacfwd.
        # (w=1e-6-scale cases are checked in f64 elsewhere; the f32 jacfwd
        # reference itself loses ~1e-2 accuracy there to cancellation.)
        for xi in [
            jnp.array([0.3, -0.5, 0.9]),
            jnp.array([1.0, 2.0, 1e-3]),
            jnp.array([0.2, 0.1, 0.0]),
            jnp.array([-0.7, 0.4, -2.5]),
        ]:
            def f(d):
                return se2.log(se2.compose(se2.exp(xi + d), se2.inverse(se2.exp(xi))))

            Jl = jax.jacfwd(f)(jnp.zeros(3))
            Jl_inv = se2.left_jacobian_inv(xi)
            assert np.allclose(Jl_inv @ Jl, np.eye(3), atol=2e-4), xi

    def test_between_jacobians_match_jacfwd(self):
        k1, k2, k3 = jax.random.split(KEY, 3)
        E = 16
        poses = jax.random.normal(k1, (2 * E, 3))
        edges = jnp.stack([jnp.arange(E), jnp.arange(E, 2 * E)], axis=1).astype(
            jnp.int32
        )
        meas = 0.5 * jax.random.normal(k2, (E, 3))
        sqrt_info = jnp.broadcast_to(jnp.eye(3), (E, 3, 3))
        mask = jnp.ones(E, bool)
        is_loop = jnp.zeros(E, bool)

        r, Ji, Jj = linearize_edges(poses, edges, meas, sqrt_info, mask, is_loop)

        # jacfwd reference
        def resid(a, b, z):
            return se2.log(se2.between(z, se2.between(a, b)))

        def lin_ref(a, b, z):
            zeros = jnp.zeros(3)
            f = lambda di, dj: resid(se2.retract(a, di), se2.retract(b, dj), z)
            return (
                f(zeros, zeros),
                jax.jacfwd(f, 0)(zeros, zeros),
                jax.jacfwd(f, 1)(zeros, zeros),
            )

        r2, Ji2, Jj2 = jax.vmap(lin_ref)(
            poses[edges[:, 0]], poses[edges[:, 1]], meas
        )
        assert np.allclose(r, r2, atol=1e-5)
        assert np.allclose(Ji, Ji2, atol=2e-4), np.abs(np.asarray(Ji - Ji2)).max()
        assert np.allclose(Jj, Jj2, atol=2e-4)

    def test_se3_between_jacobians_match_jacfwd(self):
        from graphslam.geometry import se3, so3

        k1, k2, k3, k4 = jax.random.split(KEY, 4)
        E = 12
        w = 0.8 * jax.random.normal(k1, (2 * E, 3))
        t = jax.random.normal(k2, (2 * E, 3))
        poses = se3.make(so3.exp(w), t)
        edges = jnp.stack([jnp.arange(E), jnp.arange(E, 2 * E)], axis=1).astype(
            jnp.int32
        )
        meas = se3.exp(0.4 * jax.random.normal(k3, (E, 6)))
        sqrt_info = jnp.broadcast_to(jnp.eye(6), (E, 6, 6))
        mask = jnp.ones(E, bool)
        is_loop = jnp.zeros(E, bool)

        r, Ji, Jj = linearize_edges(poses, edges, meas, sqrt_info, mask, is_loop)

        def resid(a, b, z):
            return se3.log(se3.between(z, se3.between(a, b)))

        def lin_ref(a, b, z):
            zeros = jnp.zeros(6)
            f = lambda di, dj: resid(se3.retract(a, di), se3.retract(b, dj), z)
            return (
                f(zeros, zeros),
                jax.jacfwd(f, 0)(zeros, zeros),
                jax.jacfwd(f, 1)(zeros, zeros),
            )

        r2, Ji2, Jj2 = jax.vmap(lin_ref)(poses[edges[:, 0]], poses[edges[:, 1]], meas)
        assert np.allclose(r, r2, atol=1e-4)
        assert np.allclose(Jj, Jj2, atol=5e-3), np.abs(np.asarray(Jj - Jj2)).max()
        assert np.allclose(Ji, Ji2, atol=5e-3), np.abs(np.asarray(Ji - Ji2)).max()

    def test_se3_jl_inv_identity_at_zero(self):
        from graphslam.geometry import se3

        J = se3.left_jacobian_inv(jnp.zeros(6))
        assert np.allclose(J, np.eye(6), atol=1e-6)

    def test_prior_jacobians_match_jacfwd(self):
        k1, k2 = jax.random.split(KEY)
        P = 8
        poses = jax.random.normal(k1, (P, 3))
        idx = jnp.arange(P, dtype=jnp.int32)
        meas = 0.5 * jax.random.normal(k2, (P, 3))
        sqrt_info = jnp.broadcast_to(jnp.eye(3), (P, 3, 3))
        mask = jnp.ones(P, bool)
        rp, Jp = linearize_priors(poses, idx, meas, sqrt_info, mask)

        def lin_ref(a, z):
            zeros = jnp.zeros(3)
            f = lambda d: se2.log(se2.between(z, se2.retract(a, d)))
            return f(zeros), jax.jacfwd(f)(zeros)

        rp2, Jp2 = jax.vmap(lin_ref)(poses, meas)
        assert np.allclose(rp, rp2, atol=1e-5)
        assert np.allclose(Jp, Jp2, atol=2e-4)
