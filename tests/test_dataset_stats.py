"""Synthetic benchmark generators vs the PUBLISHED dataset statistics.

The environment has no network egress, so the BASELINE configs run on
synthetic stand-ins (io/datasets.py). These tests bound the gap: the
generated graphs must match the real datasets' published pose counts, edge
counts, and loop-closure densities (SE-Sync, Rosen et al., IJRR 2019,
Table 3; g2o/vertigo releases) — the graph properties that determine both
per-iteration solver cost and optimization-basin difficulty. A benchmark
number measured on a stand-in with half the loop density would overstate
throughput; these tests make that impossible to ship silently.
"""

import numpy as np
import pytest

from graphslam.io import datasets

# name -> (generator, published poses, published edges)
PUBLISHED = {
    "m3500": (datasets.m3500, 3500, 5453),
    "city10000": (datasets.city10000, 10000, 20687),
    "sphere2500": (datasets.sphere2500, 2500, 4949),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_counts_match_published(name):
    gen, n_pub, e_pub = PUBLISHED[name]
    d = gen()
    n = len(d["poses"])
    e = len(d["edges"])
    assert n == n_pub, (name, n, n_pub)
    # within 3% of the published edge count (sphere2500 is exact)
    assert abs(e - e_pub) <= 0.03 * e_pub, (name, e, e_pub)
    # loop density follows (edges are chain + loops)
    loops = int(d["is_loop"].sum())
    loops_pub = e_pub - (n_pub - 1)
    assert abs(loops - loops_pub) <= 0.05 * loops_pub, (name, loops, loops_pub)


def test_intel_loop_density():
    # intel.g2o: 1228 poses, 1483 edges -> 0.208 loops/pose. The stand-in
    # carries SURVEY.md's ~1.7k sizing; the density is the matched quantity.
    d = datasets.intel_like()
    n = len(d["poses"])
    loops = int(d["is_loop"].sum())
    assert abs(loops / n - 0.208) < 0.03, loops / n


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_structure_sane(name):
    gen, _, _ = PUBLISHED[name]
    d = gen()
    n = len(d["poses"])
    edges = d["edges"]
    is_loop = d["is_loop"]
    # full odometry chain first (the chain_prefix contract)
    chain = edges[~is_loop]
    assert np.array_equal(chain[:, 0], np.arange(n - 1))
    assert np.array_equal(chain[:, 1], np.arange(1, n))
    # loops respect the recency exclusion and are forward-ordered
    loops = edges[is_loop]
    if len(loops):
        assert (loops[:, 1] > loops[:, 0]).all()
    # no pose is a hub: real pose graphs have bounded degree
    deg = np.bincount(edges.ravel(), minlength=n)
    assert deg.max() <= 16, deg.max()


def test_loop_spatial_consistency():
    # loop closures must connect spatially nearby ground-truth poses —
    # the property that makes them informative (and the real datasets').
    d = datasets.m3500()
    gt = d["gt"]
    loops = d["edges"][d["is_loop"]]
    dist = np.linalg.norm(gt[loops[:, 0], :2] - gt[loops[:, 1], :2], axis=-1)
    assert dist.max() <= 1.5, dist.max()
