"""The readers of the program's spans, requests and counters on hand-made
records, and on the tiny cell's traced run: every outermost stage of the
fused run read by exactly one stage metric (the rest is unstaged_s), and
every stage with a parent named in a nested_stages*.json."""
import pytest

from ngsepcore_tpu_torch.utils import profiling
from perfbench import harness, ledger, trace

MS = 1_000_000  # ns
STAGE_METRICS = ("seed_s", "select_s", "tier3_s", "call_host_s", "window_s",
                 "call_prep_s", "genotype_host_s")
NEW = ("gc_s", "host_alns_pct", "call_prep_s", "genotype_host_s", "idle_unspanned_s")


def _span(i, name, a, b, parent=None, request=1):
    return profiling.Span(i, parent, request, name, a * MS, b * MS, 0)


@pytest.fixture
def hand_made(monkeypatch):
    """The program's ledger holding the given records instead of its own."""
    def put(spans=(), requests=(), counters=None):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "requests", lambda: list(requests))
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))
    return put


def _trace(**kw):
    tr = trace.Trace(window=(0, 100 * MS), samples=2, sample_walls=[4.0, 6.0])
    for k, v in kw.items():
        setattr(tr, k, v)
    return tr


def test_interval_arithmetic():
    assert ledger.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10), (20, 25)]
    assert ledger.intersect([(0, 10)], []) == []
    assert ledger.subtract([(0, 10), (20, 30)], [(2, 4), (6, 22), (29, 40)]) == [
        (0, 2), (4, 6), (22, 29)]
    assert ledger.subtract([(0, 10)], []) == [(0, 10)]
    assert ledger.subtract([(5, 6)], [(0, 10)]) == []


def test_counter_readers(tiny_root, hand_made):
    gc_s = harness.metric_reader(tiny_root, "gc_s")
    pct = harness.metric_reader(tiny_root, "host_alns_pct")
    hand_made(counters={"gc.ns_in_request": 3_000_000_000, "align.reads": 200,
                        "align.host_alns": 30})
    assert gc_s(_trace()) == pytest.approx(1.5)
    assert pct(_trace()) == pytest.approx(15.0)
    hand_made(counters={})
    assert gc_s(_trace()) == 0.0  # the hook was on and saw no pass
    assert pct(_trace()) is None  # no read was counted
    assert gc_s(_trace(samples=0)) is None


def test_stage_readers(tiny_root):
    prep = harness.metric_reader(tiny_root, "call_prep_s")
    geno = harness.metric_reader(tiny_root, "genotype_host_s")
    tr = _trace(stages={"call.gather_host": [0.2, 4], "call.joint_cap": [1.0, 2],
                        "call.window_prep": [0.6, 40], "call.build_records": [0.4, 2],
                        "call.realign": [9.0, 32]})
    assert prep(tr) == pytest.approx(0.6)
    assert geno(tr) == pytest.approx(0.5)


def test_idle_outside_spans(tiny_root, hand_made):
    read = harness.metric_reader(tiny_root, "idle_unspanned_s")
    # device busy 10-20 and 50-60 ms: idle 0-10, 20-50, 60-100
    ev = [("k", 10 * MS, 20 * MS), ("k", 50 * MS, 60 * MS)]
    reqs = [profiling.Request(1, 5 * MS, 45 * MS), profiling.Request(2, 55 * MS, 95 * MS)]
    spans = [_span(3, "a", 8, 12), _span(4, "b", 25, 40), _span(5, "c", 27, 30, parent=4),
             _span(6, "d", 70, 80, request=2)]
    hand_made(spans=spans, requests=reqs)
    # idle in requests: 5-10, 20-45, 60-95; outside spans: 5-8, 20-25,
    # 40-45, 60-70, 80-95 = 38 ms over 2 samples
    assert read(_trace(device_events=ev)) == pytest.approx(0.019)
    assert read(_trace()) is None  # no device events: nothing to read
    hand_made(spans=spans, requests=[])
    assert read(_trace(device_events=ev)) is None


def test_a_program_without_spans_gives_nothing(tiny_root, monkeypatch):
    for name in ("spans", "requests", "counters"):
        monkeypatch.delattr(profiling, name)
    tr = _trace(device_events=[("k", 10 * MS, 20 * MS)],
                stages={"call.joint_cap": [1.0, 2], "call.build_records": [0.4, 2]})
    for name in NEW:
        assert harness.metric_reader(tiny_root, name)(tr) is None, name


def test_the_tiny_cell_reads_every_outermost_stage_once(tiny_root):
    res = harness.run_cell("tiny.fused", 11, 0.1, True, root=tiny_root, device="cpu",
                           log=lambda m: None)
    assert res["correct"], res["checks"]
    spans = profiling.spans()
    reqs = profiling.requests()
    assert spans and len(reqs) == res["attempted"]
    assert {s.request for s in spans} == {r.id for r in reqs}
    stages = {m: set(harness.metric_reader(tiny_root, m).__globals__["STAGES"])
              for m in STAGE_METRICS}
    outer = {s.name for s in spans if s.parent is None}
    for name in outer:
        readers = [m for m, names in stages.items() if name in names]
        assert len(readers) == 1, (name, readers)
    nested = harness.nested_stages(tiny_root)
    inner = {s.name for s in spans if s.parent is not None}
    assert inner <= set(nested), inner - set(nested)
    assert not outer & set(nested)
    # the seven stage metrics are the outermost spans, a sample
    outer_s = sum(s.end_ns - s.start_ns for s in spans if s.parent is None) * 1e-9
    got = sum(res["metrics"][m]["value"] for m in STAGE_METRICS)
    assert got == pytest.approx(outer_s / res["attempted"], rel=1e-6)
    for name in ("gc_s", "host_alns_pct", "call_prep_s", "genotype_host_s"):
        assert name in res["metrics"], name
    assert 0 < res["metrics"]["host_alns_pct"]["value"] < 100
    assert "idle_unspanned_s" not in res["metrics"]  # no device on the CPU
