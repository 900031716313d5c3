"""ngsepcore_tpu_torch's population caller against the JAX package's on
the CPU: accumulate_sorted_calls and genotype_window_from_counts (integer
outputs equal, ref_prob within 1e-12, N alleles in the input), and
MultisampleVariantsDetector.find_variants on both workloads of
tests/test_multisample.py (records equal line for line as VCF text)."""
import dataclasses
import io

import numpy as np
import pytest
import torch

import ngsepcore_tpu.kernels.genotyping as jg
import ngsepcore_tpu_torch.kernels.genotyping as tg
from ngsepcore_tpu.align.read_alignment import ReadAlignment as JAln
from ngsepcore_tpu.align.read_alignment import cigar_from_string
from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.multisample import MultisampleVariantsDetector as JMulti
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import encode_dna
from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.align.read_alignment import ReadAlignment as TAln
from ngsepcore_tpu_torch.call.multisample import MultisampleVariantsDetector as TMulti
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.vcf.io import VCFFileWriter

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T_ = torch.from_numpy


def port_genome(genome):
    seqs = TQSL()
    for s in genome.sequences:
        seqs.add(TQS(name=s.name, codes=np.array(s.codes)))
    return TGenome(seqs)


def port_alns(alns):
    """The port's own copies of JAX-package alignments (the realigner
    edits alignments in place, so each package gets its own)."""
    out = []
    for a in alns:
        kw = {
            f.name: getattr(a, f.name)
            for f in dataclasses.fields(a) if not f.name.startswith("_")
        }
        kw["cigar"] = list(a.cigar)
        b = TAln(**kw)
        if a._read_codes is not None:
            b._read_codes = np.array(a._read_codes)
        out.append(b)
    return out


def vcf_lines(records, samples):
    """The records as the VCF body the port's writer prints."""
    buf = io.StringIO()
    w = VCFFileWriter(buf, samples)
    for r in records:
        w.write(r)
    return [l for l in buf.getvalue().splitlines() if not l.startswith("#")]


# ---------------------------------------------------------------------------
# kernels/genotyping: the sorted-call scatter and the dense genotyper

def _sorted_calls(seed, n_calls, w0, out_size, max_q=30):
    """Position-sorted (pos, attr) like aln_table.device_calls: positions
    around [w0, w0+out_size), alleles 0..4 (4 = N), qualities 0..max_q."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(w0 - 20, w0 + out_size + 20, size=n_calls)).astype(np.int32)
    al = rng.choice(5, size=n_calls, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    q = rng.integers(0, max_q + 1, size=n_calls)
    st = rng.integers(0, 2, size=n_calls)
    attr = (q | (al << 5) | (st << 8)).astype(np.int32)
    return pos, attr


def _accumulate_both(pos, attr, lo, w0, count, out_size):
    size = 1 << 12
    assert count <= size
    j = jg.accumulate_sorted_calls(
        *jg.init_count_tensors(out_size), pos, attr, np.int32(lo), np.int32(w0),
        np.int32(count), size=size,
    )
    t = tg.accumulate_sorted_calls(
        *tg.init_count_tensors(out_size, device="cpu"), T_(pos), T_(attr), lo, w0, count,
    )
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("lo,count", [(0, 3000), (500, 2000), (2999, 1), (100, 0)])
def test_accumulate_sorted_calls_equals_jax(lo, count):
    w0, out_size = 1001, 256
    pos, attr = _sorted_calls(11, 3000, w0, out_size)
    assert ((attr >> 5) & 7 == 4).any()  # N alleles
    j, t = _accumulate_both(pos, attr, lo, w0, count, out_size)
    for name, a, b in zip(("counts", "strand_counts", "low_qual", "total"), j, t):
        assert b.dtype == np.int32 and b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    if count == 3000:
        counts, _, low, total = t
        # N calls and calls of quality <= 3 reach total and not counts
        assert counts.sum() < total.sum() - low.sum()


def test_accumulate_sorted_calls_quality_31_does_not_raise():
    """device_calls clamps qualities to 30; the function's contract does
    not.  A 31 counts toward total (and the strand counts) like the JAX
    scatter, whose out-of-range update is dropped."""
    w0, out_size = 1, 64
    pos, attr = _sorted_calls(12, 2000, w0, out_size, max_q=31)
    assert (attr & 31 == 31).any()
    j, t = _accumulate_both(pos, attr, 0, w0, 2000, out_size)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)


def test_accumulate_sorted_calls_rejects_ranges_outside_the_calls():
    pos, attr = _sorted_calls(13, 100, 1, 64)
    z = tg.init_count_tensors(64, device="cpu")
    for lo, count in ((-1, 10), (95, 10), (0, -1)):
        with pytest.raises(ValueError):
            tg.accumulate_sorted_calls(*z, T_(pos), T_(attr), lo, 1, count)


def _pileup_counts(seed, W):
    """(W, 4, 31) counts of a ~20x pileup: homozygous-reference positions
    with errors, heterozygous and homozygous variant positions, empty
    positions, N reference bases."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=W).astype(np.int8)
    ref[rng.random(W) < 0.02] = 4
    kind = rng.choice(4, size=W, p=[0.7, 0.12, 0.12, 0.06])  # ref, het, hom, empty
    alt = (np.clip(ref, 0, 3) + rng.integers(1, 4, size=W)) % 4
    counts = np.zeros((W, 4, 31), np.int32)
    strand = np.zeros((W, 4, 2), np.int32)
    total = np.zeros(W, np.int32)
    for p in range(W):
        if kind[p] == 3:
            continue
        depth = int(rng.integers(1, 40))
        r = int(np.clip(ref[p], 0, 3))
        p_alt = (0.01, 0.5, 0.99)[kind[p]]
        al = np.where(rng.random(depth) < p_alt, alt[p], r)
        err = rng.random(depth) < 0.01
        al = np.where(err, rng.integers(0, 4, size=depth), al)
        q = rng.integers(4, 31, size=depth)
        st = rng.integers(0, 2, size=depth)
        np.add.at(counts[p], (al, q), 1)
        np.add.at(strand[p], (al, st), 1)
        total[p] = depth + int(rng.integers(0, 3))  # low-quality calls
    return counts, strand, total, ref


def _genotype_both(seed, min_quality, W=4096):
    counts, strand, total, ref = _pileup_counts(seed, W)
    C = jg.snv_contribution_table(4, 0.5)
    j = jg.genotype_window_from_counts(
        counts, strand, total, ref, np.asarray(C), np.float64(0.001),
        np.int32(min_quality),
    )
    t = tg.genotype_window_from_counts(
        T_(counts), T_(strand), T_(total), T_(ref),
        T_(tg.snv_contribution_table(4, 0.5)), 0.001, min_quality,
    )
    return j, t


@pytest.mark.parametrize("seed,min_quality", [(22, 40), (23, 0), (24, 90)])
def test_genotype_window_from_counts_equals_jax(seed, min_quality):
    j, t = _genotype_both(seed, min_quality)
    k = int(j["n_sites"])
    assert t["n_sites"] == k > 50
    for key in ("site_idx", "bi", "bj", "gq", "depths", "total", "strand_counts"):
        want = np.asarray(j[key])[:k]
        got = t[key].numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key in ("bi_full", "bj_full", "gq_full", "total_full", "depths_full"):
        want = np.asarray(j[key])
        got = t[key].numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_allclose(
        t["ref_prob"].numpy(), np.asarray(j["ref_prob"])[:k], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        t["ref_prob_full"].numpy(), np.asarray(j["ref_prob_full"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        t["logcond"].numpy(), np.asarray(j["logcond"])[:k], rtol=1e-12, atol=1e-12)


def test_genotype_window_from_counts_known_gq_difference():
    """Once ROADMAP.md Queue 3's high-GQ difference: GQ is -10 log10(1 -
    best), and from GQ ~120 up 1 - best keeps under 14 significant bits,
    so the last bits of the log-likelihoods and of the normalising sum
    decide it.  The port now adds both in XLA:CPU's order (the einsum's 124
    terms one after another, the 16-term sum as four lanes folded (0+2) +
    (1+3)): at positions 2558 and 2707, JAX's 136 and 131, and every GQ
    equal (tolerance 0)."""
    j, t = _genotype_both(21, 0)
    for key in ("bi_full", "bj_full", "total_full", "depths_full", "gq_full"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]), err_msg=key)
    assert t["gq_full"].numpy()[[2558, 2707]].tolist() == [136, 131]
    np.testing.assert_array_equal(t["logcond"].numpy(), np.asarray(j["logcond"])[: t["n_sites"]])


@pytest.mark.parametrize("seed", [25, 26, 27, 28, 29, 30])
def test_genotype_window_from_counts_high_gq_equals_jax(seed):
    """4,096 pileup sites a seed, min_quality 0: every GQ, high ones
    included, equal to the JAX package's (tolerance 0)."""
    j, t = _genotype_both(seed, 0)
    gq = np.asarray(j["gq_full"])
    assert (gq >= 120).sum() > 100
    np.testing.assert_array_equal(t["gq_full"].numpy(), gq)


# ---------------------------------------------------------------------------
# MultisampleVariantsDetector.find_variants

@pytest.fixture(scope="module")
def population_case():
    """tests/test_multisample.py::test_multisample_joint_genotyping's
    workload, aligned once by the JAX aligner."""
    rng = np.random.default_rng(77)
    seqs = JQSL()
    seqs.add(JQS.from_string("chr1", "".join(rng.choice(list("ACGT"), size=30000))))
    genome = JGenome(seqs)
    aligner = JAligner(genome)
    truth_per_sample, alns_per_sample = [], []
    for si in range(3):
        sim = SingleIndividualSimulator(
            genome, snv_rate=0.001, indel_rate=0.0, het_fraction=0.4, seed=100 + si
        )
        sim.simulate()
        truth_per_sample.append({c.first: c for c in sim.calls})
        reads = []
        for h, hg in enumerate(sim.build_haplotype_genomes()):
            reads.extend(
                SingleReadsSimulator(
                    hg, read_length=100, substitution_error_rate=0.002,
                    seed=200 + 10 * si + h,
                ).simulate(5000)
            )
        alns = []
        for i in range(0, len(reads), 4096):
            for r in aligner.align_batch(reads[i : i + 4096]):
                alns.extend(r)
        alns_per_sample.append(alns)
    samples = ["s0", "s1", "s2"]
    t_alns = [port_alns(a) for a in alns_per_sample]
    jrec = JMulti(genome).find_variants(alns_per_sample, samples)
    trec = TMulti(port_genome(genome), device="cpu").find_variants(t_alns, samples)
    return truth_per_sample, samples, jrec, trec


def gq_differences(want, got):
    """[(pos, sample index or -1 for QUAL, JAX value, port value)] where
    two VCF bodies differ in nothing but a sample's GQ or the QUAL taken
    from it; any other difference fails."""
    assert len(got) == len(want)
    out = []
    for w, g in zip(want, got):
        wf, gf = w.split("\t"), g.split("\t")
        assert len(gf) == len(wf)
        for col, (a, b) in enumerate(zip(wf, gf)):
            if a == b:
                continue
            if col == 5:
                out.append((int(wf[1]), -1, int(a), int(b)))
                continue
            assert col >= 9, (w, g)
            af, bf = a.split(":"), b.split(":")
            assert af[:2] + af[3:] == bf[:2] + bf[3:], (w, g)
            out.append((int(wf[1]), col - 9, int(af[2]), int(bf[2])))
    return out


# ROADMAP.md Queue 3: GQ values whose posterior lies within 10 units in the
# last place of 1 (GQ >= 148), as the JAX package prints them.  The port
# printed 149, 149, 255, 149, 149 (and QUAL 149), 154, 255, 149, 149.
KNOWN_GQ_CELLS = {
    (3279, 0): 150, (6731, 2): 148, (8912, 0): 157, (9620, 0): 148,
    (9668, 0): 150, (9668, -1): 150, (13910, 0): 157, (17717, 2): 157,
    (18564, 0): 150, (29786, 0): 148,
}


def test_find_variants_records_equal_jax(population_case):
    """Line for line as VCF text, but for the pinned saturated GQ cells."""
    _, samples, jrec, trec = population_case
    want = vcf_lines(jrec, samples)
    assert len(want) > 50
    for pos, sample, jgq, tgq in gq_differences(want, vcf_lines(trec, samples)):
        assert KNOWN_GQ_CELLS.get((pos, sample)) == jgq, (pos, sample, jgq, tgq)
        assert tgq >= 148


def test_find_variants_meets_the_accuracy_thresholds(population_case):
    """The assertions of tests/test_multisample.py on the port's records."""
    truth_per_sample, _, _, records = population_case
    all_truth = set()
    for t in truth_per_sample:
        all_truth.update(t)
    called = {r.variant.first for r in records}
    tp = len(called & all_truth)
    assert tp / len(all_truth) > 0.9
    assert tp / len(called) > 0.9
    checked = concordant = 0
    for r in records:
        if r.variant.first not in all_truth:
            continue
        for si, call in enumerate(r.calls):
            if call.is_undecided:
                continue
            t = truth_per_sample[si].get(r.variant.first)
            checked += 1
            concordant += call.genotype_state == (0 if t is None else t.genotype_state)
    assert checked > 50
    assert concordant / checked > 0.95
    assert all(len(r.calls) == 3 for r in records)


def _deletion_case():
    """tests/test_multisample.py::test_multisample_indel_genotyping."""
    rng = np.random.default_rng(5)
    ref = "".join("ACGT"[i] for i in rng.integers(0, 4, size=400))
    seqs = JQSL()
    seqs.add(JQS(name="chr1", codes=encode_dna(ref)))

    def mk(first, cigar, read, name):
        return JAln(
            sequence_name="chr1", first=first, cigar=cigar_from_string(cigar),
            read_chars=read, qualities="I" * len(read), read_name=name,
            alignment_quality=60,
        )

    alns_a = [
        mk(60 + 7 * i, "100M", ref[59 + 7 * i : 159 + 7 * i], f"a{i}")
        for i in range(12)
    ]
    alns_b = []
    for i in range(12):
        first = 60 + 7 * (i % 6)
        pre = 120 - first + 1
        read = ref[first - 1 : 120] + ref[123 : first + 102]
        alns_b.append(mk(first, f"{pre}M3D{len(read) - pre}M", read, f"b{i}"))
    return JGenome(seqs), alns_a, alns_b


def test_find_variants_population_indel_equals_jax():
    genome, alns_a, alns_b = _deletion_case()
    samples = ["A", "B"]
    t_alns = [port_alns(alns_a), port_alns(alns_b)]
    jrec = JMulti(genome, min_quality=20).find_variants([alns_a, alns_b], samples)
    trec = TMulti(port_genome(genome), min_quality=20, device="cpu").find_variants(
        t_alns, samples)
    want = vcf_lines(jrec, samples)
    assert vcf_lines(trec, samples) == want
    indels = [r for r in trec
              if any(len(a) != len(r.variant.alleles[0]) for a in r.variant.alleles)]
    assert len(indels) == 1 and indels[0].variant.first == 120
    call_a, call_b = indels[0].calls
    assert call_a.is_homozygous_reference
    assert not call_b.is_homozygous_reference and not call_b.is_undecided


def test_find_variants_skips_samples_and_sequences_without_reads():
    """A sample with no alignment on the sequence still gets a call column
    (undecided), as in the JAX package."""
    genome, alns_a, alns_b = _deletion_case()
    samples = ["A", "B", "C"]
    jrec = JMulti(genome, min_quality=20).find_variants([alns_a, alns_b, []], samples)
    trec = TMulti(port_genome(genome), min_quality=20, device="cpu").find_variants(
        [port_alns(alns_a), port_alns(alns_b), []], samples)
    assert vcf_lines(trec, samples) == vcf_lines(jrec, samples)
    assert all(len(r.calls) == 3 for r in trec)
    assert TMulti(port_genome(genome), device="cpu").find_variants([[], []], ["A", "B"]) == []
