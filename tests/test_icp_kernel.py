"""GICP IRLS-iteration kernel vs its jnp reference, and the kernel choice.

Off the GPU the kernel runs through the Pallas interpreter (interpret=True);
the compiled kernel is checked by the `gpu`-marked tests and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphslam.ops.icp_kernel import (
    fused_icp_iteration,
    fused_icp_iteration_reference,
)

TRITON_CALL = "__gpu$xla.gpu.triton"


def make_inputs(P=256, Q=384, seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 7)
    src = 3.0 * jax.random.normal(k[0], (P, 2))
    src_mask = jax.random.bernoulli(k[1], 0.9, (P,))
    tgt = 3.0 * jax.random.normal(k[2], (Q, 2))
    tgt_valid = jax.random.bernoulli(k[3], 0.85, (Q,))
    A = jax.random.normal(k[4], (Q, 2, 2)) * 0.3
    Ct = jnp.einsum("qij,qkj->qik", A, A) + 0.1 * jnp.eye(2)
    B = jax.random.normal(k[5], (P, 2, 2)) * 0.3
    Cs = jnp.einsum("pij,pkj->pik", B, B) + 0.01 * jnp.eye(2)
    delta = jnp.array([0.1, -0.2, 0.3]) * jax.random.normal(k[6], (3,))
    return delta, src, src_mask, Cs, tgt, tgt_valid, Ct


def assert_matches(args, max_corr2):
    H1, g1, s1 = fused_icp_iteration(
        *args, max_corr2=max_corr2, eps=1e-6, interpret=True
    )
    H2, g2, s2 = fused_icp_iteration_reference(*args, max_corr2=max_corr2, eps=1e-6)
    # Sums are taken in another order (per program, then across programs).
    np.testing.assert_allclose(H1, H2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s1, s2, rtol=1e-4, atol=1e-2)
    assert float(s1[2]) == float(s2[2])  # n_match is a count: exact
    return H1, g1, s1


def test_fused_matches_reference():
    assert_matches(make_inputs(), max_corr2=1.5)


def test_fused_unaligned_P():
    assert_matches(make_inputs(P=200, Q=256, seed=1), max_corr2=1.0)


@pytest.mark.parametrize("P", [1, 130, 1081, 1152])
def test_kernel_source_sizes(P):
    # One program, a partial last program, the beam count and the budget.
    assert_matches(make_inputs(P=P, Q=1152, seed=P), max_corr2=1.0)


@pytest.mark.parametrize("Q", [1, 127, 333])
def test_kernel_target_not_power_of_two(Q):
    assert_matches(make_inputs(P=64, Q=Q, seed=Q), max_corr2=4.0)


def test_no_valid_targets():
    delta, src, src_mask, Cs, tgt, _, Ct = make_inputs(seed=2)
    tgt_valid = jnp.zeros(tgt.shape[0], bool)
    args = (delta, src, src_mask, Cs, tgt, tgt_valid, Ct)
    H, g, s = assert_matches(args, max_corr2=1.0)
    assert float(s[2]) == 0.0  # no matches
    assert np.allclose(H, 0.0) and np.allclose(g, 0.0)
    # Every valid source point reports the capped 1e9 distance.
    assert float(s[0]) == pytest.approx(1e9 * float(jnp.sum(src_mask)), rel=1e-6)


def test_everything_gated_out():
    args = make_inputs(seed=4)
    H, g, s = assert_matches(args, max_corr2=1e-12)
    assert float(s[2]) == 0.0
    assert np.allclose(H, 0.0) and np.allclose(g, 0.0)
    assert float(s[0]) > 0.0  # the ungated fitness still counts every point


def _scan_pair():
    from graphslam.config import FrontendConfig
    from graphslam.frontend import scan_to_points
    from graphslam.frontend.projection import beam_angles
    from graphslam.geometry import se2
    from graphslam.sim import default_world, raycast

    cfg = FrontendConfig(num_beams=181, max_points=256)
    angles = beam_angles(cfg.num_beams, cfg.fov_rad)
    world = default_world()

    def scan_at(pose):
        r = raycast(world, jnp.asarray(pose), angles, cfg.max_range)
        return scan_to_points(r, angles, cfg.min_range, cfg.max_range, cfg.max_points)

    tgt_pose = jnp.array([-7.0, -5.0, 0.2])
    src_pose = jnp.array([-6.85, -4.9, 0.27])
    tp, tm = scan_at(tgt_pose)
    sp, sm = scan_at(src_pose)
    return sp, sm, tp, tm, se2.between(tgt_pose, src_pose)


def test_gicp_match_fused_vs_xla():
    # End-to-end: gicp_match with the kernel (interpreted here) must recover
    # the same delta as the XLA path on real scan geometry.
    from graphslam.frontend import gicp_match

    sp, sm, tp, tm, expected = _scan_pair()
    init = expected + jnp.array([0.03, -0.03, 0.02])
    res_xla = gicp_match(
        sp, sm, tp, tm, init_delta=init, iterations=16, use_pallas=False
    )
    res_fused = gicp_match(
        sp, sm, tp, tm, init_delta=init, iterations=16, use_pallas=True,
        interpret=True,
    )
    assert np.allclose(res_xla.delta, expected, atol=0.04)
    np.testing.assert_allclose(res_fused.delta, res_xla.delta, atol=1e-4)
    assert np.allclose(res_fused.fitness, res_xla.fitness, rtol=1e-3)
    assert bool(res_fused.converged) == bool(res_xla.converged)


def test_fused_explicit_tunables_regression():
    # max_corr_dist/gicp_eps passed EXPLICITLY (as the pipeline does from
    # FrontendConfig) must reach the kernel as Python floats: gicp_match
    # keeps them static, so they are never traced.
    from graphslam.frontend import gicp_match

    _, src, src_mask, _, tgt, tgt_valid, _ = make_inputs(seed=3)
    kw = dict(iterations=4, max_corr_dist=1.25, gicp_eps=1e-3)
    res = gicp_match(src, src_mask, tgt, tgt_valid, use_pallas=True,
                     interpret=True, **kw)
    res2 = gicp_match(src, src_mask, tgt, tgt_valid, use_pallas=False, **kw)
    assert np.allclose(res.delta, res2.delta, atol=1e-3)


def _lowered_text(use_pallas, platform):
    from graphslam.frontend import gicp_match

    sp, sm, tp, tm, _ = _scan_pair()
    f = jax.jit(lambda *a: gicp_match(*a, iterations=2, use_pallas=use_pallas))
    return f.trace(sp, sm, tp, tm).lower(lowering_platforms=(platform,)).as_text()


def test_auto_choice_is_xla_off_gpu():
    # use_pallas=None on a CPU computation: no kernel, same answer as XLA.
    from graphslam.frontend import gicp_match

    assert TRITON_CALL not in _lowered_text(None, "cpu")
    with jax.default_device(jax.devices("cpu")[0]):
        sp, sm, tp, tm, _ = _scan_pair()
        a = gicp_match(sp, sm, tp, tm, iterations=4, use_pallas=None)
        b = gicp_match(sp, sm, tp, tm, iterations=4, use_pallas=False)
    np.testing.assert_array_equal(a.delta, b.delta)


def test_auto_choice_is_kernel_on_gpu():
    # The same call lowered for a CUDA device holds the Triton kernel.
    assert TRITON_CALL in _lowered_text(None, "cuda")
    assert TRITON_CALL not in _lowered_text(False, "cuda")


def test_interpret_never_derived_from_platform():
    # Asking for the kernel on the CPU without interpret=True must fail,
    # not quietly run the interpreter.
    with pytest.raises(Exception):
        _lowered_text(True, "cpu")


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    # Full budget on simulated-scan-sized inputs, compiled for the card.
    args = make_inputs(P=1152, Q=1152, seed=7)
    H1, g1, s1 = fused_icp_iteration(*args, max_corr2=1.0, eps=1e-6)
    with jax.default_matmul_precision("highest"):
        H2, g2, s2 = fused_icp_iteration_reference(*args, max_corr2=1.0, eps=1e-6)
    np.testing.assert_allclose(H1, H2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-3)
    assert float(s1[2]) == float(s2[2])


@pytest.mark.gpu
def test_compiled_gicp_match_matches_xla(gpu):
    from graphslam.frontend import gicp_match

    sp, sm, tp, tm, expected = _scan_pair()
    init = expected + jnp.array([0.03, -0.03, 0.02])
    res = {use: gicp_match(sp, sm, tp, tm, init_delta=init, iterations=16,
                           use_pallas=use) for use in (True, False)}
    np.testing.assert_allclose(res[True].delta, res[False].delta, atol=1e-4)
