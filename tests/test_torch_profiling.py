"""The port's stage ledger (ngsepcore_tpu_torch/utils/profiling.py): spans
with ids, parents, requests and times on time.time_ns()'s clock, the
collector's hook and counters, and the stage table in its old shape; and
what the fused pipeline records with the ledger on and off (CPU)."""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector
from ngsepcore_tpu_torch.core.genome import ReferenceGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList
from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def ledger():
    """The ledger on and empty; afterwards off, empty and as it was."""
    was = profiling.enabled()
    profiling.enable(False)
    profiling.reset()
    profiling.enable(True)
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()
        profiling.enable(was)


@pytest.fixture
def no_auto_gc():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_ids_parents_and_requests(ledger):
    with ledger.request() as rid:
        with ledger.stage("a"):
            with ledger.stage("b"):
                with ledger.stage("c"):
                    pass
            with ledger.stage("b2"):
                pass
        with ledger.stage("d"):
            pass
    with ledger.stage("outside"):
        pass
    sp = _by_name(ledger.spans())
    assert set(sp) == {"a", "b", "c", "b2", "d", "outside"}
    assert len({s.id for s in sp.values()} | {rid}) == 7
    assert sp["a"].parent is None and sp["d"].parent is None
    assert sp["b"].parent == sp["a"].id and sp["b2"].parent == sp["a"].id
    assert sp["c"].parent == sp["b"].id
    assert {sp[n].request for n in ("a", "b", "c", "b2", "d")} == {rid}
    assert sp["outside"].request is None and sp["outside"].parent is None
    (req,) = ledger.requests()
    assert req.id == rid
    assert "request" not in ledger._stages and len(ledger._stages) == 6


def test_spans_on_the_wall_clock(ledger):
    t0 = time.time_ns()
    with ledger.request():
        t1 = time.time_ns()
        with ledger.stage("sleep"):
            time.sleep(0.003)
        t2 = time.time_ns()
    t3 = time.time_ns()
    (s,) = ledger.spans()
    (r,) = ledger.requests()
    assert t1 <= s.start_ns < s.end_ns <= t2
    assert s.end_ns - s.start_ns >= 3_000_000
    assert t0 <= r.start_ns <= s.start_ns and s.end_ns <= r.end_ns <= t3


def test_stage_table_keeps_its_shape(ledger):
    for _ in range(3):
        with ledger.stage("x"):
            time.sleep(0.001)
    total, calls = ledger._stages["x"]
    assert isinstance(ledger._stages["x"], list) and calls == 3
    spans_s = sum(s.end_ns - s.start_ns for s in ledger.spans()) * 1e-9
    assert total == pytest.approx(spans_s, abs=1e-4)


def test_nothing_is_recorded_and_no_hook_while_off():
    was = profiling.enabled()
    profiling.enable(False)
    profiling.reset()
    hooks = list(gc.callbacks)
    try:
        with profiling.request() as rid:
            with profiling.stage("off"):
                profiling.count("off.count", 5)
                gc.collect()
        assert rid is None
        assert profiling.spans() == [] and profiling.requests() == []
        assert profiling.counters() == {} and profiling._stages == {}
        assert gc.callbacks == hooks
        profiling.enable(True)
        assert len(gc.callbacks) == len(hooks) + 1
        profiling.enable(True)
        assert len(gc.callbacks) == len(hooks) + 1
        profiling.enable(False)
        assert gc.callbacks == hooks
    finally:
        profiling.reset()
        profiling.enable(was)


def test_a_collection_is_charged_to_the_innermost_span(ledger, no_auto_gc):
    with ledger.request():
        with ledger.stage("outer"):
            with ledger.stage("inner"):
                gc.collect(1)
    sp = _by_name(ledger.spans())
    c = ledger.counters()
    assert c["gc.gen1.passes"] == 1 and c["gc.gen1.ns"] > 0
    assert "gc.gen0.passes" not in c and "gc.gen2.passes" not in c
    assert sp["inner"].gc_ns == c["gc.gen1.ns"] == c["gc.ns_in_request"]
    assert sp["outer"].gc_ns == 0
    assert sp["inner"].gc_ns <= sp["inner"].end_ns - sp["inner"].start_ns
    # outside a request a pass is counted by generation only
    gc.collect(2)
    c = ledger.counters()
    assert c["gc.gen2.passes"] == 1 and c["gc.ns_in_request"] == sp["inner"].gc_ns


def test_a_collection_on_another_thread_is_charged_to_the_request(ledger, no_auto_gc):
    with ledger.request():
        with ledger.stage("main"):
            t = threading.Thread(target=gc.collect, args=(0,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    (s,) = ledger.spans()
    c = ledger.counters()
    assert c["gc.gen0.passes"] == 1
    assert s.gc_ns == c["gc.gen0.ns"] == c["gc.ns_in_request"] > 0


def test_count_reset_and_records_kept_after_disable(ledger):
    ledger.count("work", 2)
    ledger.count("work", 3)
    with ledger.request():
        with ledger.stage("s"):
            pass
    ledger.enable(False)
    ledger.count("work", 100)
    with ledger.stage("late"):
        pass
    assert ledger.counters() == {"work": 5}
    assert [s.name for s in ledger.spans()] == ["s"]
    assert len(ledger.requests()) == 1 and list(ledger._stages) == ["s"]
    ledger.reset()
    assert ledger.spans() == [] and ledger.requests() == []
    assert ledger.counters() == {} and ledger._stages == {}


def test_report_gives_self_and_collector_time(ledger, no_auto_gc):
    with ledger.stage("outer"):
        time.sleep(0.004)
        with ledger.stage("inner"):
            time.sleep(0.006)
            gc.collect(0)
    own = ledger._self_and_gc()
    sp = _by_name(ledger.spans())
    outer_ns = sp["outer"].end_ns - sp["outer"].start_ns
    inner_ns = sp["inner"].end_ns - sp["inner"].start_ns
    assert own["outer"][0] == pytest.approx((outer_ns - inner_ns) * 1e-9)
    assert own["inner"] == (pytest.approx(inner_ns * 1e-9), pytest.approx(sp["inner"].gc_ns * 1e-9))
    assert own["outer"][1] == 0
    import io

    text = ledger.report(io.StringIO())
    lines = {ln.split()[0]: ln for ln in text.splitlines()[1:] if ln.startswith("  ")}
    assert set(lines) == {"outer", "inner"}
    assert f"self {own['outer'][0]:9.3f}s" in lines["outer"]
    assert "collector: gen0 1 passes" in text


def _tiny_sample(seed=5):
    rng = np.random.default_rng(seed)
    seqs = QualifiedSequenceList()
    for name, n in (("chrA", 20000), ("chrB", 12000)):
        seqs.add(QualifiedSequence(name=name, codes=rng.integers(0, 4, size=n).astype(np.int8)))
    genome = ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.002, indel_rate=0.0005, seed=seed + 1)
    sim.simulate()
    reads = []
    for h, hg in enumerate(sim.build_haplotype_genomes()):
        reads.extend(SingleReadsSimulator(hg, read_length=100, substitution_error_rate=0.004,
                                          seed=seed + 10 + h).simulate(1200))
    return genome, reads


def _run(genome, reads):
    pipe = AlignCallPipeline(
        genome, aligner=ReadsAligner(genome, device="cpu"),
        detector=SingleSampleVariantsDetector(genome, sample_id="s1", device="cpu"),
        batch_size=1024, device="cpu")
    return pipe.run_reads(reads)


def test_the_fused_path_records_spans_requests_and_counters():
    genome, reads = _tiny_sample()
    was = profiling.enabled()
    profiling.enable(False)
    profiling.reset()
    hooks = list(gc.callbacks)
    try:
        off = _run(genome, reads)
        assert profiling.spans() == [] and profiling.requests() == []
        assert profiling.counters() == {} and profiling._stages == {}
        assert gc.callbacks == hooks
        profiling.enable(True)
        on = _run(genome, reads)
        profiling.enable(False)
        assert gc.callbacks == hooks
    finally:
        spans, reqs, counts = profiling.spans(), profiling.requests(), profiling.counters()
        profiling.reset()
        profiling.enable(was)
    assert [r.variant.first for r in on] == [r.variant.first for r in off] and len(on) > 10
    (req,) = reqs
    assert {s.request for s in spans} == {req.id}
    assert all(req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns for s in spans)
    names = {s.name for s in spans}
    for name in ("call.gather_host", "call.window_bounds", "call.stage_build",
                 "call.window_prep", "call.window_dispatch", "indel.p2a_consensus"):
        assert name in names
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("indel.p2") and s.name != "indel.p2_alleles":
            assert ids[s.parent].name == "indel.p2_alleles"
        if s.name.startswith("alntab."):
            assert ids[s.parent].name == "call.aln_table"
        if s.name.startswith("call."):
            assert s.parent is None
    assert counts["align.reads"] == len(reads)
    assert 0 < counts["align.host_alns"] < counts["align.reads"]
