"""The port's benchmark tools and TILLING simulation against the JAX package
on the CPU (ROADMAP.md item 17c).

The cases of tests/test_benchmark_tools.py (10), the gold-standard cases
of tests/test_haplotyping_benchmark.py (2) and the TILLING cases of
tests/test_long_tail.py (2) run through both packages on inputs built with
each package's own classes, with the JAX tests' checks on the port's side.
Each tool's whole state after the run (counts, histograms, categories),
its printed report and its records are held equal to the JAX package's:
every output here is an integer, a string or a float computed by the same
host numpy steps, so equality is exact.  A seeded TILLING population
simulates the same pools in both packages."""
import io

import numpy as np
import pytest

import ngsepcore_tpu.align.read_alignment as jaln
import ngsepcore_tpu.benchmark.gold_standard as jgold
import ngsepcore_tpu.benchmark.quality_stats as jqs
import ngsepcore_tpu.benchmark.sv_comparison as jsv
import ngsepcore_tpu.core.genome as jgenome
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.simulation.tilling as jtil
import ngsepcore_tpu.variants.model as jmodel
import ngsepcore_tpu.vcf.io as jio
import ngsepcore_tpu_torch.align.read_alignment as taln
import ngsepcore_tpu_torch.benchmark.gold_standard as tgold
import ngsepcore_tpu_torch.benchmark.quality_stats as tqs
import ngsepcore_tpu_torch.benchmark.sv_comparison as tsv
import ngsepcore_tpu_torch.core.genome as tgenome
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.simulation.tilling as ttil
import ngsepcore_tpu_torch.variants.model as tmodel
import ngsepcore_tpu_torch.vcf.io as tio

J = dict(model=jmodel, io=jio, qs=jqs, sv=jsv, gold=jgold, aln=jaln, seq=jseq,
         genome=jgenome, til=jtil)
T = dict(model=tmodel, io=tio, qs=tqs, sv=tsv, gold=tgold, aln=taln, seq=tseq,
         genome=tgenome, til=ttil)


def _state(x):
    """An object's fields as plain Python, recursively (numpy arrays as
    (dtype, shape, values)), so two packages' objects compare by value."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_state(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_state(v) for v in x)
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _state(vars(x)))
    slots = getattr(type(x), "__slots__", None)
    if slots is not None:
        return (type(x).__name__, {k: _state(getattr(x, k, None)) for k in slots})
    return x


def _call(P, gt, alleles=("A", "T"), first=100):
    """tests/test_benchmark_tools.py's call, built with one package."""
    c = P["model"].CalledGenomicVariant(
        sequence_name="chr1", first=first, alleles=list(alleles),
        variant_type=P["model"].TYPE_BIALLELIC_SNV, genotype_quality=60,
    )
    c.indexes_called_alleles = {None: [], 0: [0], 1: [0, 1], 2: [1]}[gt]
    return c


def _rec(P, genos, first=100):
    v = P["model"].CalledGenomicVariant(
        sequence_name="chr1", first=first, alleles=["A", "T"],
        variant_type=P["model"].TYPE_BIALLELIC_SNV,
    )
    return P["io"].VCFRecord(variant=v, calls=[_call(P, g) for g in genos])


def _both(run):
    """run(package) for each package; their states must be equal."""
    j, t = run(J), run(T)
    assert _state(t) == _state(j)
    return t


def _report(obj, method="print_statistics"):
    buf = io.StringIO()
    getattr(obj, method)(buf)
    return buf.getvalue()


# ---- tests/test_benchmark_tools.py ---------------------------------------

def test_inbred_family_stats_equal_jax():
    samples = ["P1", "P2", "F1", "F2", "F3", "F4"]

    def run(P):
        recs = [_rec(P, [0, 2, 0, 0, 2, 2]), _rec(P, [0, 2, 0, 1, 2, 2], first=200)]
        q = P["qs"].QualityStatisticsInbredBiparentalFamilies()
        q.process(recs, samples, "P1", "P2")
        return q, _report(q)

    q, text = _both(run)
    assert q.total_vars == 2
    assert q.vars_per_category[1] == 1 and q.vars_per_category[2] == 1
    assert q.progeny_errors[2] == 1
    assert "SUMMARY COUNTS" in text


def test_outbred_f1_consistency_equal_jax():
    def run(P):
        recs = [_rec(P, [0, 2, 1, 1]), _rec(P, [0, 2, 1, 0], first=300)]
        q = P["qs"].QualityStatisticsOutbredF1Families()
        q.process(recs, ["P1", "P2", "A", "B"], "P1", "P2")
        return q

    q = _both(run)
    assert q.total_datapoints == 4 and q.inconsistent_datapoints == 1


def test_tetraploid_f1_maf_dosage_histogram_equal_jax():
    def run(P):
        q = P["qs"].QualityStatisticsTetraploidF1Families()
        q.process([_rec(P, [0, 1, 1, 2])])
        return q, _report(q)

    q, text = _both(run)
    row = q.counts_minor_allele_dosage[50]
    assert row[0] == 1 and row[2] == 2 and row[4] == 1
    assert text.startswith("MAF\tHomozygous major")


def test_readblock_concat_differing_default_quality_equal_jax():
    def run(P):
        RB = P["seq"].ReadBlock
        a = RB(np.zeros((2, 4), np.int8), np.array([4, 3], np.int32), default_quality=40)
        b = RB(np.ones((1, 4), np.int8), np.array([4], np.int32), default_quality=20)
        merged = RB.concatenate([a, b])
        return merged, [merged[i].qualities for i in range(3)]

    merged, quals = _both(run)
    assert merged.quals is not None
    assert quals == [chr(73) * 4, chr(73) * 3, chr(53) * 4]


def test_alignment_simulated_stats_equal_jax():
    def run(P):
        A = P["aln"]
        alns = [
            A.ReadAlignment("chr1", 500, A.cigar_from_string("100M"),
                            read_name="chr1_500_599_0", read_chars="A" * 100,
                            alignment_quality=60),
            A.ReadAlignment("chr1", 777, A.cigar_from_string("100M"),
                            read_name="chr1_500_599_1", read_chars="A" * 100,
                            alignment_quality=60),
        ]
        q = P["qs"].QualityStatisticsAlignmentSimulatedReads(min_alignment_quality=20)
        q.process(alns)
        return q, q.stats()

    _, s = _both(run)
    assert s["aligned"] == 2 and s["correct"] == 1


@pytest.mark.parametrize("inferred,truth", [
    ([0, 1, 1, 0, 0], [0, 1, 0, 1, 1]),
    ([0, 0, 1, 1, 0, 1, 1, 0], [1, 1, 0, 0, 0, 1, 0, 1]),
])
def test_switch_errors_equal_jax(inferred, truth):
    def run(P):
        return P["qs"].KmerBasedSwitchErrorsFinder().count_switch_errors(
            np.array(inferred), np.array(truth))

    sw, comps = _both(run)
    if len(inferred) == 5:
        assert comps == 4 and sw == 1


def test_sv_direct_comparison_equal_jax():
    def run(P):
        def sv(first, last, t="DEL"):
            return P["model"].CalledGenomicVariant(
                sequence_name="chr1", first=first, alleles=["N"], variant_type=t,
                last_=last)

        gold = [sv(1000, 2000), sv(5000, 6000), sv(9000, 9500, "INV")]
        test = [sv(1100, 2100), sv(7000, 7500)]
        stats = P["sv"].VCFDirectSVComparison().compare(gold, test)
        return stats, stats.sensitivity, stats.precision

    stats, sens, _ = _both(run)
    assert stats.true_positives == 1 and stats.false_positives == 1
    assert stats.false_negatives == 2 and 0 < sens < 1


def test_biparental_gold_standard_equal_jax():
    def run(P):
        return P["sv"].BiparentalHaploidGoldStandardBuilder().build(
            [_rec(P, [2]), _rec(P, [1], first=300)], [_rec(P, [0]), _rec(P, [0], first=300)])

    truth = _both(run)
    assert len(truth) >= 1 and set(truth[0][3]) == {"A", "T"}


def test_assemblies_transcript_stats_equal_jax():
    def run(P):
        st = P["sv"].AssembliesAlignedTranscriptStatistics()
        st.process({"t1": [(1, 100)], "t2": [(1, 40), (45, 100)], "t3": []},
                   {"t1": 100, "t2": 100, "t3": 100})
        return st

    st = _both(run)
    assert st.complete == 1 and st.fragmented == 1 and st.missing == 1


def test_add_ad_field_equal_jax():
    def run(P):
        rec = _rec(P, [1])
        rec.calls[0].allele_depths = None
        rec.calls[0].acgt_depths = [5, 0, 0, 7]
        P["qs"].VCFAddADGTField().transform([rec])
        return rec

    rec = _both(run)
    assert rec.calls[0].allele_depths == [5, 7]


# ---- tests/test_haplotyping_benchmark.py: the gold-standard comparator ----

def _grec(P, pos, alleles, idxs, gq=60, seq="chr1"):
    c = P["model"].CalledGenomicVariant(
        sequence_name=seq, first=pos, alleles=list(alleles),
        indexes_called_alleles=list(idxs), genotype_quality=gq, sample_id="s",
    )
    return P["io"].VCFRecord(variant=c, calls=[c])


@pytest.mark.parametrize("tolerance", [0, 2])
def test_gold_standard_comparator_equal_jax(tolerance):
    def run(P):
        gold = [_grec(P, 10, "AC", [0, 1]), _grec(P, 20, "AG", [1, 1]),
                _grec(P, 30, "AT", [0, 1])]
        test = [_grec(P, 10, "AC", [0, 1], gq=80), _grec(P, 20, "AG", [0, 1], gq=70),
                _grec(P, 40, "AC", [1, 1], gq=90), _grec(P, 31, "AT", [0, 1], gq=50)]
        comp = P["gold"].VCFGoldStandardComparator(position_tolerance=tolerance)
        c = comp.compare(gold, test)
        return c, [c.stats_at(q) for q in (0, 60, 85)], _report(comp, "print_report")

    c, stats, _ = _both(run)
    if tolerance == 0:
        assert stats[0]["tp"] == 1
        assert stats[0]["fp"] == 3  # genotype error at 20, unmatched 31 and 40
        assert stats[0]["fn"] == 1 and c.genotype_errors == 1


def test_gold_standard_quality_binning_equal_jax():
    def run(P):
        comp = P["gold"].VCFGoldStandardComparator()
        comp.compare([_grec(P, 10, "AC", [0, 1])], [_grec(P, 10, "AC", [0, 1], gq=30)])
        return comp, comp.counts.stats_at(0), comp.counts.stats_at(40), \
            _report(comp, "print_report")

    _, s0, s40, text = _both(run)
    assert s0["tp"] == 1 and s40["tp"] == 0 and s40["fn"] == 1
    assert "MinGQ" in text


# ---- tests/test_long_tail.py: TILLING ------------------------------------

@pytest.fixture(scope="module")
def tilling_runs():
    """tests/test_long_tail.py::test_tilling_roundtrip's population (96
    individuals in 8 x 12 pools over a 20 kb genome, seed 5) in each
    package."""
    seq = "".join(np.random.default_rng(2).choice(list("ACGT"), size=20000))
    out = {}
    for tag, P in (("j", J), ("t", T)):
        g = P["genome"].ReferenceGenome(
            P["seq"].QualifiedSequenceList([P["seq"].QualifiedSequence.from_string("chr1", seq)]))
        sim = P["til"].TillingPopulationSimulator(g, n_individuals=96, seed=5)
        sim.build_design()
        sim.simulate_mutations(2.0)
        pools = sim.pool_variant_records()
        assigned = P["til"].TillingPoolsIndividualGenotyper(sim.design).genotype(pools)
        out[tag] = (sim, pools, assigned)
    return out


def test_tilling_roundtrip_equal_jax(tilling_runs):
    (js, jp, ja), (ts, tp, ta) = tilling_runs["j"], tilling_runs["t"]
    assert ts.mutations == js.mutations and len(ts.mutations) > 100
    assert _state(ts.design) == _state(js.design)
    assert _state(tp) == _state(jp)
    assert _state(ta) == _state(ja)
    truth = {(ind, pos) for ind, _, pos, _, _ in ts.mutations}
    got = {(ind, r.variant.first) for ind, r in ta}
    assert len(got & truth) / len(truth) > 0.9
    assert not (got - truth)


def test_tilling_individual_vcf2pool_vcf_equal_jax(tmp_path):
    desc = tmp_path / "pools.txt"
    desc.write_text("Individual;Pool1;Pool2\nind1;R1;C1\nind2;R1;C2\nind3;R2;C1\n")

    def run(P):
        pools = P["til"].load_pool_configuration(str(desc))
        conv = P["til"].TillingIndividualVCF2PoolVCF(pools)

        def call(sample, idxs):
            return P["model"].CalledGenomicVariant(
                sequence_name="chr1", first=100, alleles=["A", "T"],
                variant_type=P["model"].TYPE_BIALLELIC_SNV, sample_id=sample,
                indexes_called_alleles=idxs)

        rec = P["io"].VCFRecord(
            variant=call(None, []),
            calls=[call("ind1", [0, 1]), call("ind2", [0]), call("ind3", [1])])
        return pools, conv, conv.convert([rec])

    pools, conv, out = _both(run)
    assert pools == {"ind1": ["R1", "C1"], "ind2": ["R1", "C2"], "ind3": ["R2", "C1"]}
    assert conv.pool_ids == ["C1", "C2", "R1", "R2"]
    assert conv.pool_ploidy == {"C1": 4, "C2": 2, "R1": 4, "R2": 2}
    by_pool = {c.sample_id: c for c in out[0].calls}
    assert by_pool["R1"].allele_copy_numbers == [3, 1]
    assert by_pool["C1"].allele_copy_numbers == [1, 3]
    assert by_pool["R2"].allele_copy_numbers == [0, 2]
