"""g2o reader/writer round-trips and synthetic dataset sanity."""

import numpy as np

from graphslam.io import datasets, load_g2o, save_g2o


class TestG2O:
    def test_roundtrip_se2(self, tmp_path):
        data = datasets.manhattan(n_poses=50, seed=7)
        path = str(tmp_path / "test2d.g2o")
        save_g2o(path, data)
        back = load_g2o(path, use_native=False)
        assert back["dim"] == 2
        assert np.allclose(back["poses"], data["poses"], atol=1e-5)
        assert np.array_equal(back["edges"], data["edges"])
        assert np.allclose(back["measurements"], data["measurements"], atol=1e-5)
        assert np.allclose(back["information"], data["information"], rtol=1e-5)

    def test_roundtrip_se3(self, tmp_path):
        data = datasets.sphere(n_rings=4, poses_per_ring=6, radius=3.0)
        path = str(tmp_path / "test3d.g2o")
        save_g2o(path, data)
        back = load_g2o(path, use_native=False)
        assert back["dim"] == 3
        # Rotations go through quaternions; compare R and t separately.
        assert np.allclose(back["poses"][:, 9:], data["poses"][:, 9:], atol=1e-5)
        assert np.allclose(back["poses"][:, :9], data["poses"][:, :9], atol=1e-4)
        assert np.allclose(back["measurements"][:, :9], data["measurements"][:, :9], atol=1e-4)
        assert np.allclose(back["information"], data["information"], rtol=1e-4)


class TestG2ORobustness:
    def test_comments_shuffled_vertices_and_fix(self, tmp_path):
        # Real-world g2o files carry comments, FIX tags, and out-of-order
        # vertices; the loader must take them in stride.
        data = datasets.manhattan(n_poses=20, seed=50)
        path = str(tmp_path / "messy.g2o")
        save_g2o(path, data)
        lines = open(path).read().strip().split("\n")
        vx = [l for l in lines if l.startswith("VERTEX")]
        ed = [l for l in lines if l.startswith("EDGE")]
        messy = ["# a comment", "FIX 0"] + ed[:3] + vx[::-1] + ed[3:]
        with open(path, "w") as f:
            f.write("\n".join(messy) + "\n")
        back = load_g2o(path, use_native=False)
        assert np.allclose(back["poses"], data["poses"], atol=1e-5)
        assert set(map(tuple, back["edges"].tolist())) == set(
            map(tuple, data["edges"].tolist())
        )

    def test_native_handles_messy_file(self, tmp_path):
        import pytest

        try:
            from graphslam.io import native_g2o
            native_g2o._lib()
        except OSError:
            pytest.skip("native parser not built")
        data = datasets.manhattan(n_poses=20, seed=51)
        path = str(tmp_path / "messy2.g2o")
        save_g2o(path, data)
        lines = open(path).read().strip().split("\n")
        with open(path, "w") as f:
            f.write("# header\nFIX 0\n" + "\n".join(lines[::-1]) + "\n")
        a = load_g2o(path, use_native=False)
        b = load_g2o(path, use_native=True)
        assert np.allclose(a["poses"], b["poses"], atol=1e-12)


class TestNativeParser:
    def test_native_matches_python(self, tmp_path):
        import pytest

        try:
            from graphslam.io import native_g2o
            native_g2o._lib()
        except OSError:
            pytest.skip("native parser not built (make -C native)")
        data = datasets.manhattan(n_poses=200, seed=21)
        path = str(tmp_path / "n.g2o")
        save_g2o(path, data)
        a = load_g2o(path, use_native=False)
        b = load_g2o(path, use_native=True)
        for k in ("poses", "edges", "measurements", "information"):
            assert np.allclose(a[k], b[k], atol=1e-12), k

    def test_native_se3(self, tmp_path):
        import pytest

        try:
            from graphslam.io import native_g2o
            native_g2o._lib()
        except OSError:
            pytest.skip("native parser not built (make -C native)")
        data = datasets.sphere(n_rings=4, poses_per_ring=6, radius=3.0)
        path = str(tmp_path / "n3.g2o")
        save_g2o(path, data)
        a = load_g2o(path, use_native=False)
        b = load_g2o(path, use_native=True)
        for k in ("poses", "edges", "measurements", "information"):
            assert np.allclose(a[k], b[k], atol=1e-10), k


class TestCheckpoint:
    def test_roundtrip_slam_state(self, tmp_path):
        import jax.numpy as jnp

        from graphslam.config import FrontendConfig, SLAMConfig
        from graphslam.io.checkpoint import save_state, load_slam_state
        from graphslam.slam import init_state

        cfg = SLAMConfig(
            max_keyframes=16, max_factors=32,
            frontend=FrontendConfig(num_beams=8, max_points=16),
        )
        s = init_state(cfg)
        s = s.replace(num_kf=jnp.int32(3), anchor=jnp.array([1.0, 2.0, 0.3]))
        path = str(tmp_path / "state.npz")
        save_state(path, s)
        back = load_slam_state(path)
        assert int(back.num_kf) == 3
        assert np.allclose(back.anchor, [1.0, 2.0, 0.3])
        assert back.kf_points.shape == s.kf_points.shape


class TestLogs:
    def test_roundtrip(self, tmp_path):
        from graphslam.config import FrontendConfig
        from graphslam.io.logs import save_log, load_log

        cfg = FrontendConfig(num_beams=5)
        scans = np.random.default_rng(0).uniform(0.1, 10.0, (7, 5)).astype(np.float32)
        odom = np.zeros((6, 3), np.float32)
        gt = np.zeros((7, 3), np.float32)
        p = str(tmp_path / "run.npz")
        save_log(p, scans, odom, gt, cfg)
        back = load_log(p)
        assert np.allclose(back["scans"], scans)
        assert back["num_beams"] == 5
        assert back["odom_deltas"].shape == (6, 3)


class TestDatasets:
    def test_manhattan_shapes(self):
        d = datasets.manhattan(n_poses=200, seed=1)
        assert d["poses"].shape == (200, 3)
        assert d["edges"].shape[0] == d["measurements"].shape[0]
        assert d["edges"].max() < 200
        assert (d["edges"][:, 0] < d["edges"][:, 1]).all()
        # Odometry chain present.
        assert (d["edges"][:199, 1] == d["edges"][:199, 0] + 1).all()
        # Some loop closures exist.
        assert d["is_loop"].sum() > 0

    def test_sphere_valid_rotations(self):
        d = datasets.sphere(n_rings=5, poses_per_ring=8)
        R = d["gt"][:, :9].reshape(-1, 3, 3)
        RtR = np.einsum("nji,njk->nik", R, R)
        assert np.allclose(RtR, np.eye(3)[None], atol=1e-5)

    def test_deterministic(self):
        a = datasets.manhattan(n_poses=100, seed=9)
        b = datasets.manhattan(n_poses=100, seed=9)
        assert np.array_equal(a["measurements"], b["measurements"])
