"""CLI: optimize a pose graph (g2o file or named synthetic benchmark).

  python scripts/solve.py m3500 --plot /tmp/m3500.png
  python scripts/solve.py path/to/intel.g2o --out /tmp/optimized.g2o
  python scripts/solve.py city10000 --mode pcg --iters 100 --huber
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", help="g2o path or benchmark name (m3500, intel, ...)")
    ap.add_argument("--mode", default="auto", choices=["auto", "dense", "pcg"])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--huber", action="store_true")
    ap.add_argument("--precond", default="tridiag", choices=["tridiag", "jacobi"])
    ap.add_argument(
        "--init", default="dataset", choices=["dataset", "chordal"],
        help="initial guess: dataset poses or SE(2) chordal bootstrap",
    )
    ap.add_argument("--out", help="write optimized graph to this g2o path")
    ap.add_argument("--plot", help="write trajectory plot to this png path")
    args = ap.parse_args()

    from graphslam import metrics
    from graphslam.config import SolverConfig
    from graphslam.factors import chi2, from_dataset
    from graphslam.io import datasets, save_g2o
    from graphslam.solver import lm_solve
    from graphslam.utils import enable_compile_cache

    enable_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)

    data = datasets.load(args.dataset)
    graph = from_dataset(data)
    poses0 = jnp.asarray(data["poses"])
    if args.init == "chordal":
        if data["dim"] != 2:
            print("chordal init is SE(2)-only for now", file=sys.stderr)
            sys.exit(2)
        from graphslam.solver.init import chordal_init_se2

        poses0 = chordal_init_se2(graph, poses0.shape[0])
    cfg = SolverConfig(
        mode=args.mode,
        max_iterations=args.iters,
        cg_max_iterations=args.cg_iters,
        use_huber_on_loops=args.huber,
        preconditioner=args.precond,
    )

    t0 = time.time()
    out = jax.block_until_ready(lm_solve(poses0, graph, cfg))
    dt = time.time() - t0

    print(f"poses: {poses0.shape[0]}  edges: {graph.num_edges}", file=sys.stderr)
    print(
        f"chi2: {float(chi2(poses0, graph)):.1f} -> {float(out.error):.1f} "
        f"in {int(out.iterations)} LM iterations ({dt:.2f}s incl. compile)",
        file=sys.stderr,
    )
    if "gt" in data:
        gt = jnp.asarray(data["gt"])
        print(
            f"ATE: {float(metrics.ate(poses0, gt)):.4f} -> "
            f"{float(metrics.ate(out.poses, gt)):.4f}",
            file=sys.stderr,
        )

    if args.out:
        save_g2o(
            args.out,
            {
                "dim": data["dim"],
                "poses": np.asarray(out.poses),
                "edges": np.asarray(graph.edges),
                "measurements": np.asarray(graph.measurements),
                "information": np.asarray(
                    jnp.einsum("eba,ebc->eac", graph.sqrt_info, graph.sqrt_info)
                ),
            },
        )
        print(f"wrote {args.out}", file=sys.stderr)
    if args.plot:
        from graphslam import viz

        viz.plot_trajectory(
            np.asarray(out.poses),
            gt=data.get("gt"),
            edges=np.asarray(graph.edges),
            is_loop=np.asarray(graph.is_loop),
            path=args.plot,
            title=args.dataset,
        )
        print(f"wrote {args.plot}", file=sys.stderr)


if __name__ == "__main__":
    main()
