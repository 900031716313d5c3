"""The per-layer arithmetic on hand-made readings, and a configuration,
traffic mix and metric that the harness finds by name alone."""
import json
from collections import Counter

import pytest

from perfbench import harness, peaks, trace
from perfbench.tests.conftest import make_root

MS = 1_000_000  # ns


def _trace(**kw):
    tr = trace.Trace(window=(0, 100 * MS), samples=2, sample_walls=[4.0, 6.0],
                     nested={"align.tier3_dispatch": "align.tier3_dp"})
    for k, v in kw.items():
        setattr(tr, k, v)
    return tr


def test_stage_sums_per_sample_and_unstaged_counts_nested_once():
    tr = _trace(stages={"align.seed_dispatch": [1.0, 4], "align.seed_fetch": [0.5, 4],
                        "align.tier3_dp": [2.0, 8], "align.tier3_dispatch": [1.5, 8]})
    assert trace.stage_total(tr, ("align.seed_dispatch", "align.seed_fetch")) == 0.75
    assert trace.stage_total(tr, ("align.tier3_dp",)) == 1.0
    assert trace.stage_total(tr, ("call.realign",)) is None
    # (10 s of samples - 3.5 s in outer stages) / 2 samples
    assert trace.unstaged(tr) == pytest.approx(3.25)
    assert trace.unstaged(_trace(samples=0)) is None


def test_idle_share_is_the_union_of_device_intervals_over_the_window():
    ev = [("k1", 10 * MS, 20 * MS), ("k2", 15 * MS, 30 * MS),  # overlap: 10..30
          ("copy", 50 * MS, 60 * MS), ("late", 95 * MS, 120 * MS)]  # clipped to 95..100
    tr = _trace(device_events=ev)
    assert trace.busy_ns(tr) == 35 * MS
    assert trace.idle_pct(tr) == pytest.approx(65.0)
    assert trace.gaps(tr) == [(0, 10 * MS), (30 * MS, 50 * MS), (60 * MS, 95 * MS)]
    assert trace.idle_pct(_trace()) is None


def test_idle_gaps_are_shared_by_host_samples():
    ev = [("k", 10 * MS, 90 * MS)]
    host = [(2 * MS, "a"), (4 * MS, "a"), (6 * MS, "b"), (95 * MS, "c")]
    got = dict(trace.idle_by_host(_trace(device_events=ev, host_samples=host)))
    assert got["a"] == pytest.approx(10 * 2 / 3 * 1e-3)
    assert got["b"] == pytest.approx(10 / 3 * 1e-3)
    assert got["c"] == pytest.approx(10e-3)


def test_device_ops_sum_by_short_name():
    ev = [("void ns::kern<1>(int*, int)", 0, 2 * MS), ("void ns::kern<1>(int*, int)", 5 * MS, 6 * MS),
          ("Memcpy HtoD (Pageable -> Device)", 7 * MS, 8 * MS)]
    ops = trace.device_ops(_trace(device_events=ev))
    assert ops[0] == ["ns::kern<1>", pytest.approx(3e-3)]
    assert ops[1] == ["Memcpy HtoD (Pageable -> Device)", pytest.approx(1e-3)]


def test_frozen_bounds():
    # one launch of 1 x 1 x 1: bytes 2 + 8 + 4 + 16, ops 45 -> bytes bound
    assert peaks.gotoh_bound_s(1, 1, 1) == pytest.approx(30 / peaks.HBM_BYTES_PER_S)
    B, Lq, Ls = 256, 160, 192
    ops = peaks.GOTOH_OPS_PER_CELL * B * Lq * Ls
    assert peaks.gotoh_bound_s(B, Lq, Ls) == pytest.approx(ops / peaks.INT32_OPS_PER_S)
    w, lanes = 1 << 20, 160
    assert peaks.shear_bound_s(w, lanes) == pytest.approx(
        max((w * lanes + 512 * w) / peaks.HBM_BYTES_PER_S,
            11 * w * lanes / peaks.INT32_OPS_PER_S))


def test_roofline_readers(tmp_path):
    root = make_root(tmp_path)
    g = harness.metric_reader(root, "gotoh_roofline")
    s = harness.metric_reader(root, "shear_roofline")
    need = 3 * peaks.gotoh_bound_s(256, 160, 192)
    ev = [("void (anonymous namespace)::gotoh_forward_warp_kernel<5>(int)", 0, int(2 * need * 1e9))]
    tr = _trace(device_events=ev, gotoh_shapes=Counter({(256, 160, 192): 3}))
    assert g(tr) == pytest.approx(50.0, rel=1e-4)  # ns rounding of the event
    assert s(tr) is None  # no shear kernel in the window: nothing to read
    assert g(_trace()) is None


def test_a_dummy_cell_and_metric_are_found_by_name(tmp_path):
    """A traffic mix (smaller batches, two distinct samples), a cell and a
    per-layer metric, each added as files, run without an edit."""
    reader = "def read(tr):\n    return float(tr.samples)\n"
    traffic = {"why": "test", "kind": "closed_loop_samples", "batch_size": 4096,
               "warmup_samples": 1, "distinct_samples": 2}
    root = make_root(tmp_path, extra_metric=reader, traffic=traffic)
    spec = harness.load_cell(root, "tiny.dummy")
    assert spec["config"]["name"] == "tiny"
    assert spec["traffic"]["batch_size"] == 4096
    assert "gl_mismatch" in spec["limits"]
    assert "samples_done" in [m["name"] for m in spec["per_layer"]]
    res = harness.run_cell("tiny.dummy", 3, 0.1, True, root=root, device="cpu",
                           log=lambda m: None)
    assert res["metrics"]["samples_done"] == {"value": 1.0, "unit": "samples"}
    assert res["correct"], res["checks"]
    json.dumps(res)
