"""The readers of the program's frame records (frame_records.py and the
metrics pool_occupancy, refill_ms_per_frame, bounce_ms_per_frame,
transfer_ms_per_frame): None where the program keeps no records, the
value by hand on synthetic records of a traced window."""

from __future__ import annotations

import types

import pytest

from portbench import manifest

NAMES = ("pool_occupancy", "refill_ms_per_frame", "bounce_ms_per_frame",
         "transfer_ms_per_frame")


def _rec(profiled, lanes, live, fpr, pool, upload, fetch):
    return {"profiled": profiled,
            "counts": {"lanes": lanes, "live": live},
            "device_ms": {"fpr": fpr, "pool": pool, "flush": 1.0},
            "spans": [{"name": "frame", "t0_ms": 0.0, "t1_ms": 300.0},
                      {"name": "upload", "t0_ms": 0.0, "t1_ms": upload},
                      {"name": "pool_step", "t0_ms": 9.0, "t1_ms": 10.0},
                      {"name": "fetch", "t0_ms": 290.0,
                       "t1_ms": 290.0 + fetch}]}


def _run(frames, requests=2):
    ren = types.SimpleNamespace(trace=types.SimpleNamespace(frames=frames))
    return {"entry": types.SimpleNamespace(ren=ren), "requests": requests}


@pytest.mark.parametrize("name", NAMES)
def test_no_records_reads_none(name):
    read = manifest.metric_reader(name)
    # a program without the tracer, an untraced run, no profiled frame
    assert read(_run(None)) is None
    assert read({"entry": types.SimpleNamespace(ren=object()),
                 "requests": 2}) is None
    assert read(_run([_rec(False, 10, 5, 1.0, 2.0, 3.0, 4.0)])) is None
    assert read(_run([_rec(True, 10, 5, 1.0, 2.0, 3.0, 4.0)], 0)) is None


@pytest.mark.parametrize("name,want", [
    ("pool_occupancy", 100.0 * (30 + 50) / (40 + 100)),
    ("refill_ms_per_frame", (2.0 + 4.0) / 2),
    ("bounce_ms_per_frame", (100.0 + 120.0) / 2),
    ("transfer_ms_per_frame", ((5.0 + 14.0) + (6.0 + 12.0)) / 2)])
def test_records_read_by_hand(name, want):
    """The last `requests` profiled records: an older profiled window and
    unprofiled frames around them are left out."""
    frames = [_rec(True, 7, 7, 99.0, 99.0, 99.0, 99.0),
              _rec(False, 1, 1, 99.0, 99.0, 99.0, 99.0),
              _rec(True, 40, 30, 2.0, 100.0, 5.0, 14.0),
              _rec(True, 100, 50, 4.0, 120.0, 6.0, 12.0),
              _rec(False, 1, 1, 99.0, 99.0, 99.0, 99.0)]
    assert manifest.metric_reader(name)(_run(frames)) == pytest.approx(want)
