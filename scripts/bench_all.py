"""Full benchmark matrix (BASELINE.json configs) — writes JSON to stdout.

Configs:
  1. intel     — GN, ATE + iterations/s
  2. m3500     — LM + Huber on loops, ATE + iterations/s
  3. frontend  — simulated scans through the online pipeline, frames/s
  4. city10000 — large 2D graph, iterations/s
  5. sphere2500/garage — SE(3), iterations/s
  6. dist      — factor-sharded solver on all visible devices, scaling check
  7. dist_schur — pose-partitioned Schur solver at 1 and n devices

Runs on the GPU(s) JAX finds and stops with an error when it finds none:
  python scripts/bench_all.py [--quick] [--skip intel,m3500,...]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(x):
    return jax.block_until_ready(x)


def time_fn(fn, *args, reps=3):
    sync(fn(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def bench_posegraph(name, data, cfg, iters, lm=False, chain=8, ate_gate=None):
    """Quality and throughput from the SAME solver configuration: the solve
    that is timed (`iters` GN iterations of _gn_loop, or `iters` LM steps of
    lm_solve when lm=True — Huber and all) is the solve whose ATE/chi2 are
    reported. `ate_gate` is an ABSOLUTE meters bound; missing it marks the
    row invalid (a broken solver must not post a throughput number)."""
    import dataclasses

    from graphslam import metrics
    from graphslam.factors import from_dataset, chi2
    from graphslam.solver import lm_solve
    from graphslam.solver.lm import _gn_loop, _solve_mode

    graph = from_dataset(data)
    poses0 = jnp.asarray(data["poses"])
    gt = jnp.asarray(data["gt"])
    mode = _solve_mode(cfg, poses0.shape[0])
    if lm:
        tcfg = dataclasses.replace(cfg, max_iterations=iters)

        def solve_one(p):
            return lm_solve(p, graph, tcfg).poses
    else:
        def solve_one(p):
            return _gn_loop(p, graph, cfg, mode, iters)

    # Steady state (same as bench.py): chain `chain` solves inside one jit,
    # each feeding the next (a real data dependency).
    @jax.jit
    def solve_chain(p):
        def body(p, _):
            return solve_one(p), None
        return jax.lax.scan(body, p, None, length=chain)[0]

    out = jax.jit(solve_one)(poses0)  # the exact solve being timed
    ate = float(metrics.ate(out, gt))
    ate0 = float(metrics.ate(poses0, gt))
    chi2_final = float(chi2(out, graph))

    dt = time_fn(solve_chain, poses0)
    its = chain * iters / dt
    valid = ate_gate is None or ate < ate_gate
    log(f"{name}: mode={mode} lm={lm} "
        f"ATE {ate0:.3f}->{ate:.3f} "
        f"(gate {ate_gate}) chi2 {float(chi2(poses0, graph)):.0f}->"
        f"{chi2_final:.0f} {its:.1f} it/s valid={valid}")
    row = {
        "ate_init": round(ate0, 4),
        "ate": round(ate, 4),
        "chi2": round(chi2_final, 1),
        "iterations_per_s": round(its, 2) if valid else 0.0,
        "mode": mode,
        "lm": lm,
        "valid": valid,
    }
    if ate_gate is not None:
        row["ate_gate"] = ate_gate
    return row


def bench_frontend(quick):
    from graphslam.config import FrontendConfig, SLAMConfig, SolverConfig
    from graphslam.sim import simulate_trajectory
    from graphslam.slam import make_slam_step, init_state

    # Default (mission-scale) capacities: occupancy-bucketed solves keep
    # per-step cost tracking the live map. 4 GN iterations at cg 12 per
    # keyframe: each periodic solve starts from the poses the previous one
    # left (graph.cpp:130's warm start).
    cfg = SLAMConfig(
        max_keyframes=1024,
        max_factors=1024,
        solve_iterations=4,
        solver=SolverConfig(cg_max_iterations=12),
    )
    sim = simulate_trajectory(cfg.frontend, step_len=0.25, seed=1)
    scans = sim["scans"]
    odom = sim["odom_deltas"]
    n = 60 if quick else min(300, len(scans))

    from graphslam.slam.pipeline import make_slam_replay

    replay = make_slam_replay(cfg, n)
    scans_d = jnp.asarray(scans[:n])
    odom_d = jnp.concatenate(
        [jnp.zeros((1, 3)), jnp.asarray(odom[: n - 1])], axis=0
    )
    state, infos = replay(init_state(cfg), scans_d, odom_d)  # compile
    sync(state.kf_poses)
    t0 = time.perf_counter()
    state, infos = replay(init_state(cfg), scans_d, odom_d)
    sync(state.kf_poses)
    dt = time.perf_counter() - t0
    fps = n / dt
    log(f"frontend: {fps:.1f} frames/s over {n} scans "
        f"({int(state.num_kf)} keyframes, {int(state.num_factors)} factors)")
    return {"frames_per_s": round(fps, 2), "keyframes": int(state.num_kf)}


def bench_distributed(quick):
    from graphslam.config import SolverConfig
    from graphslam.factors import from_dataset
    from graphslam.io import datasets
    from graphslam.parallel import make_mesh, shard_graph, dist_gn_solve

    data = datasets.m3500() if not quick else datasets.manhattan(1000, seed=5)
    graph = from_dataset(data)
    poses0 = jnp.asarray(data["poses"])
    cfg = SolverConfig(mode="pcg", cg_max_iterations=50, cg_tol=1e-30)
    iters = 10

    results = {}
    n_dev = len(jax.devices())
    chain = 4  # steady state (see bench_posegraph)
    for nd in sorted({1, n_dev}):
        mesh = make_mesh(num_devices=nd)
        sharded = shard_graph(graph, mesh)

        @jax.jit
        def solve_chain(p):
            def body(p, _):
                return dist_gn_solve(p, sharded, mesh, cfg, iterations=iters), None
            return jax.lax.scan(body, p, None, length=chain)[0]

        dt = time_fn(solve_chain, poses0)
        results[f"devices_{nd}"] = round(chain * iters / dt, 2)
        log(f"dist GN {nd} devices: {chain*iters/dt:.1f} it/s")
    if len(results) > 1:
        eff = results[f"devices_{n_dev}"] / (results["devices_1"] * n_dev)
        results["scaling_efficiency"] = round(eff, 3)
    return results


def bench_dist_schur(quick):
    """Fully-sharded partitioned-Schur GN (BASELINE config 5) at {1, n}."""
    from graphslam.factors import from_dataset, chi2
    from graphslam import metrics
    from graphslam.io import datasets
    from graphslam.parallel import make_mesh
    from graphslam.parallel.dist_schur import dist_schur_gn_solve
    from graphslam.solver.schur import schur_plan

    out = {}
    n_dev = len(jax.devices())
    # Note: partitioned Schur is the banded-graph solver (schur.py header);
    # loop-dense m3500 has a large separator (Q~1.9k of 3.5k poses) — the
    # row is reported with Q so the layout's (un)suitability is visible.
    if quick:
        cases = [("manhattan1k", lambda: datasets.manhattan(1000, seed=5), 8, 10)]
    else:
        cases = [("m3500", datasets.m3500, 8, 10),
                 ("sphere2500", datasets.sphere2500, 8, 10)]
    for name, ds, blocks, iters in cases:
        data = ds()
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        gt = jnp.asarray(data["gt"])
        plan = schur_plan(
            np.asarray(graph.edges), poses0.shape[0], max(blocks, n_dev)
        )
        row = {"separator_poses": int(plan.Q)}
        for nd in sorted({1, n_dev}):
            mesh = make_mesh(num_devices=nd)
            sol = dist_schur_gn_solve(
                poses0, graph, plan, mesh, iterations=iters
            )
            ate = float(metrics.ate(sol, gt))
            dt = time_fn(
                dist_schur_gn_solve, poses0, graph, plan, mesh, iters
            )
            row[f"devices_{nd}"] = round(iters / dt, 2)
            row[f"ate_{nd}"] = round(ate, 4)
            log(f"dist_schur {name} {nd} devices: {iters/dt:.1f} it/s "
                f"ATE {ate:.3f} (Q={plan.Q})")
        if len([k for k in row if k.startswith("devices_")]) > 1:
            eff = row[f"devices_{n_dev}"] / (row["devices_1"] * n_dev)
            row["scaling_efficiency"] = round(eff, 3)
        out[name] = row
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--skip", default="", help="comma-separated config names")
    args = ap.parse_args()
    skip = set(args.skip.split(","))

    from graphslam.config import SolverConfig
    from graphslam.io import datasets
    from graphslam.utils import enable_compile_cache, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}

    # Absolute ATE gates (meters): the converged values on these generators
    # are stable, so gate near them — a solver regression posts valid=false
    # + 0 it/s instead of a fast wrong answer.
    if "intel" not in skip:
        out["intel_gn"] = bench_posegraph(
            "intel", datasets.intel_like(),
            SolverConfig(mode="pcg", cg_max_iterations=25, max_iterations=50),
            iters=25, ate_gate=0.2,
        )
    if "m3500" not in skip:
        out["m3500_lm_huber"] = bench_posegraph(
            "m3500", datasets.m3500(),
            SolverConfig(mode="pcg", cg_max_iterations=25,
                         use_huber_on_loops=True, max_iterations=80),
            iters=50, lm=True, ate_gate=0.35,
        )
    if "city10000" not in skip and not args.quick:
        out["city10000_gn"] = bench_posegraph(
            "city10000", datasets.city10000(),
            SolverConfig(mode="pcg", cg_max_iterations=50, max_iterations=100),
            iters=20, ate_gate=0.6,
        )
    if "sphere2500" not in skip and not args.quick:
        out["sphere2500_se3"] = bench_posegraph(
            "sphere2500", datasets.sphere2500(),
            SolverConfig(mode="pcg", cg_max_iterations=25, max_iterations=80),
            iters=20, ate_gate=0.2,
        )
    if "garage" not in skip and not args.quick:
        out["garage_se3"] = bench_posegraph(
            "garage", datasets.garage(),
            SolverConfig(mode="pcg", cg_max_iterations=25, max_iterations=60),
            iters=20, ate_gate=0.2,
        )
    if "frontend" not in skip:
        out["frontend"] = bench_frontend(args.quick)
    if "dist" not in skip:
        out["distributed"] = bench_distributed(args.quick)
    if "dist_schur" not in skip:
        out["dist_schur"] = bench_dist_schur(args.quick)

    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
