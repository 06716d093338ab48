"""Interactive teleop driver for the simulator — the vendored
teleop_twist_keyboard.py equivalent (scripts/teleop_twist_keyboard.py:76-131
in the reference).

Drive the simulated robot through the default world with the same key map
(u i o / j k l / m , .), feeding scans + odometry into the online SLAM
pipeline and periodically dumping a map image.

Run: python scripts/teleop.py [--out /tmp/slam_map.png]
Keys: i forward, , back, j/l turn, k stop, q/z speed up/down, Ctrl-C quit.
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import argparse
import sys
import termios
import tty

import jax.numpy as jnp
import numpy as np

from graphslam.config import SLAMConfig
from graphslam.frontend.projection import beam_angles
from graphslam.geometry import se2
from graphslam.sim import default_world, raycast
from graphslam.slam import init_state, make_slam_step
from graphslam import viz

# The reference's moveBindings/speedBindings subset that applies to a
# differential-drive planar robot.
MOVE = {
    "i": (1.0, 0.0), ",": (-1.0, 0.0),
    "j": (0.0, 1.0), "l": (0.0, -1.0),
    "u": (1.0, 1.0), "o": (1.0, -1.0),
    "m": (-1.0, -1.0), ".": (-1.0, 1.0),
    "k": (0.0, 0.0),
}
SPEED = {"q": 1.1, "z": 0.9}


def getch():
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/slam_map.png")
    ap.add_argument("--dt", type=float, default=0.1)  # willow.world:46 tick
    args = ap.parse_args()

    cfg = SLAMConfig()
    fcfg = cfg.frontend
    world = default_world()
    angles = beam_angles(fcfg.num_beams, fcfg.fov_rad)
    step = make_slam_step(cfg)
    state = init_state(cfg)

    pose = jnp.array([-7.0, -5.0, 0.0])
    speed, turn = 0.5, 1.0  # teleop_twist_keyboard.py:82-83 defaults
    print(__doc__)
    tick = 0
    while True:
        try:
            key = getch()
        except KeyboardInterrupt:
            break
        if key == "\x03":
            break
        if key in SPEED:
            speed *= SPEED[key]
            turn *= SPEED[key]
            print(f"speed {speed:.2f} turn {turn:.2f}")
            continue
        if key not in MOVE:
            continue
        v, w = MOVE[key]
        twist = np.array([v * speed, 0.0, w * turn], np.float32)
        delta = jnp.asarray(twist * args.dt)
        pose = se2.compose(pose, delta)
        ranges = raycast(world, pose, angles, fcfg.max_range)
        state, info = step(state, ranges, delta)
        tick += 1
        print(
            f"t={tick} kf={int(info.num_kf)} factors={int(info.num_factors)} "
            f"fitness={float(info.fitness):.3f}"
            + (" [keyframe]" if bool(info.is_keyframe) else "")
            + (" [loop]" if bool(info.added_loop) else "")
        )
        if bool(info.is_keyframe):
            viz.plot_map(
                state.kf_poses, state.kf_points, state.kf_masks,
                int(state.num_kf), path=args.out,
            )
    print(f"map written to {args.out}")


if __name__ == "__main__":
    main()
