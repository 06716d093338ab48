"""Regenerate the docs demo figures: closed-loop SLAM over the simulated
world -> docs/demo_map.png + docs/demo_traj.png.

  python scripts/demo.py [--beams 541] [--out docs]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", type=int, default=541)
    ap.add_argument("--out", default="docs")
    args = ap.parse_args()

    from graphslam import metrics, viz
    from graphslam.config import FrontendConfig, SLAMConfig, SolverConfig
    from graphslam.sim import simulate_trajectory
    from graphslam.slam import run_slam
    from graphslam.utils import enable_compile_cache

    enable_compile_cache()

    max_points = -(-args.beams // 128) * 128
    cfg = SLAMConfig(
        max_keyframes=256, max_factors=1024,
        frontend=FrontendConfig(
            num_beams=args.beams, max_points=max_points, icp_iterations=16
        ),
        solver=SolverConfig(mode="pcg", cg_max_iterations=50),
    )
    sim = simulate_trajectory(cfg.frontend, step_len=0.3, seed=7)
    state, infos = run_slam(sim["scans"], sim["odom_deltas"], cfg)

    n = int(state.num_kf)
    kf_steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
    gt = sim["gt_poses"][kf_steps]
    ate = float(
        metrics.ate(jnp.asarray(np.asarray(state.kf_poses[:n])), jnp.asarray(gt))
    )
    loops = sum(bool(i.added_loop) for i in infos)
    print(f"keyframes {n}, loop closures {loops}, ATE {ate:.3f} m")

    os.makedirs(args.out, exist_ok=True)
    viz.plot_map(
        state.kf_poses, state.kf_points, state.kf_masks, n,
        path=os.path.join(args.out, "demo_map.png"),
    )
    from graphslam.slam.pipeline import state_to_dataset

    ds = state_to_dataset(state)
    # align ground truth into the estimate frame for the overlay (ATE above
    # is computed with the same rigid alignment)
    R, t = metrics.align_umeyama(
        jnp.asarray(gt[:, :2]), jnp.asarray(np.asarray(state.kf_poses[:n, :2]))
    )
    gt_aligned = np.asarray(gt).copy()
    gt_aligned[:, :2] = np.asarray(gt[:, :2] @ np.asarray(R).T + np.asarray(t))
    viz.plot_trajectory(
        np.asarray(state.kf_poses[:n]), gt=gt_aligned,
        edges=ds["edges"],
        is_loop=ds["is_loop"],
        # live pose_opti marginal covariances (Keyframe.msg contract) as
        # 1-sigma ellipses, the way rviz renders covariance markers
        covariances=ds["covariances"],
        ellipse_every=8,
        ellipse_sigma=1.0,
        path=os.path.join(args.out, "demo_traj.png"),
        title=f"closed-loop SLAM ({n} keyframes, ATE {ate:.2f} m)",
    )
    print(f"wrote {args.out}/demo_map.png {args.out}/demo_traj.png")


if __name__ == "__main__":
    main()
