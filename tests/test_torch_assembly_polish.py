"""ngsepcore_tpu_torch's assembly post-processing against the JAX package
on the CPU: consensus polishing (substitutions and indels), contig end
overlaps, merging, circularization and containment, read indel
correction, read phasing and the ploidy-2 assembly.  Inputs are those of
tests/test_assembly_polish.py, the larger ones cut in length; contigs,
reads, counts and clusters must be equal (tolerance 0).  Each
workload's JAX run happens once, in a module fixture."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.assembly import phasing as jphasing
from ngsepcore_tpu.assembly import polishing as jpol
from ngsepcore_tpu.assembly.assembler import Assembler as JAssembler
from ngsepcore_tpu.assembly.read_correction import correct_reads_indels as jcorrect
from ngsepcore_tpu.core.sequences import decode_dna, encode_dna, reverse_complement_codes
from ngsepcore_tpu_torch.assembly import phasing as tphasing
from ngsepcore_tpu_torch.assembly import polishing as tpol
from ngsepcore_tpu_torch.assembly.assembler import Assembler as TAssembler
from ngsepcore_tpu_torch.assembly.read_correction import correct_reads_indels as tcorrect
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from test_assembly_polish import _reads_from, _reads_with_indels

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)


def _port_reads(reads):
    return [TRawRead(name=r.name, sequence=r.sequence) for r in reads]


def _same_arrays(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _substitution_input():
    """test_polish_fixes_draft_errors' draft (1% substitutions) and reads."""
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), size=15000))
    truth = encode_dna(genome)
    draft = truth.copy()
    idx = np.nonzero(rng.random(len(draft)) < 0.01)[0]
    draft[idx] = (draft[idx] + rng.integers(1, 4, len(idx))) % 4
    return draft, _reads_from(genome, 120, 2500, rng, error_rate=0.003)


def _indel_input():
    """test_polish_fixes_draft_indels' draft (a 2 bp deletion and a 1 bp
    insertion) on a genome cut from 12 kb to 8 kb, 100 reads."""
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), size=8000))
    truth = encode_dna(genome)
    draft = np.concatenate([truth[:3000], truth[3002:6000], encode_dna("A"), truth[6000:]])
    return draft, _reads_from(genome, 100, 2500, rng, error_rate=0.002)


@pytest.fixture(scope="module")
def jax_polished():
    draft, reads = _substitution_input()
    sub = jpol.polish_contigs([draft], reads, rounds=1)
    draft, reads = _indel_input()
    ind = jpol.polish_contigs([draft], reads, rounds=2)
    return {"substitutions": sub, "indels": ind}


@pytest.mark.parametrize("name", ["substitutions", "indels"])
def test_polish_contigs_equal_jax(jax_polished, name):
    draft, reads = (_substitution_input if name == "substitutions" else _indel_input)()
    got, n = tpol.polish_contigs([draft], _port_reads(reads),
                                 rounds=1 if name == "substitutions" else 2, device="cpu")
    want, jn = jax_polished[name]
    assert n == jn and n > 0
    assert _same_arrays(got, want)


def test_end_overlap_merge_circularize_equal_jax():
    """test_detect_end_overlap_and_merge's and
    test_circularize_trims_duplicated_end's contigs, both orientations."""
    rng = np.random.default_rng(9)
    g = encode_dna("".join(rng.choice(list("ACGT"), size=20000)))
    a, b = g[:12000], g[10500:]
    for x, y in ((a, b), (b, a), (a, reverse_complement_codes(b)), (a[:3000], b)):
        assert tpol.detect_end_overlap(x, y) == jpol.detect_end_overlap(x, y)
    assert tpol.detect_end_overlap(a, b) is not None
    for contigs in ([a, b], [a, reverse_complement_codes(b)], [g[:5000], g[7000:]]):
        assert _same_arrays(tpol.merge_contig_ends(contigs), jpol.merge_contig_ends(contigs))
    core = np.random.default_rng(10).integers(0, 4, 30000).astype(np.int8)
    for c in (np.concatenate([core, core[:2000]]), core):
        got, jgot = tpol.circularize(c), jpol.circularize(c)
        assert got[1] == jgot[1] and np.array_equal(got[0], jgot[0])


def test_containment_equal_jax():
    """find_containment on contained, overlapping, noisy and reversed
    pieces, then drop_contained_contigs on all of them."""
    rng = np.random.default_rng(14)
    g = encode_dna("".join(rng.choice(list("ACGT"), size=16000)))
    noisy = g[4000:9000].copy()
    idx = np.nonzero(rng.random(len(noisy)) < 0.03)[0]
    noisy[idx] = (noisy[idx] + 1) % 4
    pieces = [g, g[2000:6000], reverse_complement_codes(g[8000:11000]), noisy,
              np.concatenate([g[14000:], rng.integers(0, 4, 3000).astype(np.int8)])]
    for x in pieces:
        for y in pieces:
            assert tpol.find_containment(x, y) == jpol.find_containment(x, y)
    kept = tpol.drop_contained_contigs(pieces)
    assert _same_arrays(kept, jpol.drop_contained_contigs(pieces))
    assert 1 < len(kept) < len(pieces)


def test_correct_reads_indels_equal_jax():
    """Reads with 4% substitutions and 2% indels against the true
    sequence as the draft: the corrected reads and the event count."""
    rng = np.random.default_rng(15)
    genome = "".join(rng.choice(list("ACGT"), size=4000))
    reads = _reads_with_indels(genome, 20, 1500, rng)
    want, jn = jcorrect([encode_dna(genome)], reads)
    got, n = tcorrect([encode_dna(genome)], reads, device="cpu")
    assert n == jn and n > 20
    assert _same_arrays(got, want)


def _diploid_reads():
    """test_diploid_phased_assembly's input cut from 20 kb to 7 kb and
    from 2 x 80 reads of 3 kb to 2 x 28 of 2.5 kb; returns (haplotype 0,
    reads)."""
    rng = np.random.default_rng(12)
    h0 = encode_dna("".join(rng.choice(list("ACGT"), size=7000)))
    h1 = h0.copy()
    idx = np.arange(150, len(h1) - 150, 300)
    h1[idx] = (h1[idx] + 1) % 4
    reads = []
    for hap in (h0, h1):
        for _ in range(28):
            s = int(rng.integers(0, len(hap) - 2500))
            codes = hap[s : s + 2500].copy()
            e = np.nonzero(rng.random(2500) < 0.003)[0]
            codes[e] = (codes[e] + rng.integers(1, 4, len(e))) % 4
            if rng.random() < 0.5:
                codes = reverse_complement_codes(codes)
            reads.append(codes)
    return h0, reads


@pytest.fixture(scope="module")
def jax_diploid():
    from ngsepcore_tpu.core.sequences import RawRead

    h0, reads = _diploid_reads()
    draft = [h0]  # haplotype 0 as the draft: every het site shows against it
    raw = [RawRead(name=f"r{i}", sequence=decode_dna(r)) for i, r in enumerate(reads)]
    clusters = jphasing.phase_reads(draft, raw)
    contigs = JAssembler(ploidy=2, polish_rounds=1).assemble(reads)
    return draft, raw, clusters, [(s.name, decode_dna(s.codes)) for s in contigs]


def test_phase_reads_equal_jax(jax_diploid):
    draft, raw, want, _ = jax_diploid
    got = tphasing.phase_reads(draft, _port_reads(raw), device="cpu")
    assert got == want
    assert want[0] != want[1]


def test_diploid_assembly_equal_jax(jax_diploid):
    """Assembler(ploidy=2): draft, phasing, one assembly a haplotype."""
    got = TAssembler(ploidy=2, polish_rounds=1, device="cpu").assemble(_diploid_reads()[1])
    got = [(s.name, decode_dna(s.codes)) for s in got]
    assert got == jax_diploid[3]
    names = [n for n, _ in got]
    assert any("hap0" in n for n in names) and any("hap1" in n for n in names)
