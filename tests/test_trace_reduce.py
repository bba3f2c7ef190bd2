"""The trace reduction of benchmarks/trace_headline.py on synthetic events."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

from trace_headline import reduce_events  # noqa: E402


def test_busy_union_idle_share_and_counts():
    events = [
        ("Stream #1", "fusion_a", 0, 10),
        ("Stream #1", "fusion_b", 5, 20),   # overlaps a: union 0..20
        ("Stream #2", "fusion_a", 30, 40),  # gap 20..30 is idle
        ("Stream #1", "memcpy", 40, 50),    # touches: union 30..50
    ]
    out = reduce_events(events, n_steps=2)
    assert out["window_ns"] == 50
    assert out["busy_ns"] == 40
    assert out["idle_share"] == pytest.approx(0.2)
    assert out["events_per_step"] == 2.0
    assert out["per_step_us_device"] == pytest.approx(0.025)
    assert out["lines"] == ["Stream #1", "Stream #2"]
    assert out["top"][0] == {"name": "fusion_a", "total_ns": 20,
                             "share_of_busy": 0.5}


def test_no_device_events_is_an_error():
    with pytest.raises(ValueError, match="no device events"):
        reduce_events([], n_steps=1)
