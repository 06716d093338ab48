"""Observability helpers."""

import time

from graphslam.utils import Counters, Stopwatch


def test_stopwatch_accumulates():
    sw = Stopwatch()
    for _ in range(3):
        with sw.time("stage"):
            time.sleep(0.01)
    s = sw.summary()["stage"]
    assert s["count"] == 3
    assert s["total_s"] >= 0.03
    assert s["mean_ms"] >= 10.0


def test_counters():
    c = Counters()
    c.bump("keyframes")
    c.bump("keyframes")
    c.bump("loops", 5)
    assert c.as_dict() == {"keyframes": 2, "loops": 5}
