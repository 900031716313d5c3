"""The port's k-mer modules against the JAX package's on the same inputs
(CPU): k-mer codes, sorted counts, KmersMap merge/lookup/saturation, the
extractor's map, distribution file and npz, the spectrum analyzer, the
de-Bruijn mini assembler, the corrected reads, and the two CLI commands.
Every output is an integer array or text, so equality is exact.  Inputs
are those of tests/test_kmers.py and tests/test_reads_processing.py, made
from numpy seeds."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.core.sequences import RawRead as JRawRead
from ngsepcore_tpu.core.sequences import decode_dna, encode_dna, pack_reads
from ngsepcore_tpu.index.error_correction import (
    DeBruijnGraphExplorationMiniAssembler as JAssembler,
)
from ngsepcore_tpu.index.error_correction import ReadsFileErrorsCorrector as JCorrector
from ngsepcore_tpu.index.kmers_analyzer import KmersMapAnalyzer as JAnalyzer
from ngsepcore_tpu.index.kmers_extractor import KmersExtractor as JExtractor
from ngsepcore_tpu.index.kmers_map import KmersMap as JMap
from ngsepcore_tpu.kernels import kmers as jk
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from ngsepcore_tpu_torch.index.error_correction import (
    DeBruijnGraphExplorationMiniAssembler as TAssembler,
)
from ngsepcore_tpu_torch.index.error_correction import ReadsFileErrorsCorrector as TCorrector
from ngsepcore_tpu_torch.index.kmers_analyzer import KmersMapAnalyzer as TAnalyzer
from ngsepcore_tpu_torch.index.kmers_extractor import KmersExtractor as TExtractor
from ngsepcore_tpu_torch.index.kmers_map import KmersMap as TMap
from ngsepcore_tpu_torch.kernels import kmers as tk
from test_kmers import brute_force_kmers

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy


def _batch(seed=42, n=20, L=60):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), size=L)) for _ in range(n)]
    seqs.append("ACGTN" + "ACGT" * 10)
    seqs.append("ACGTACG")  # shorter than k = 15
    codes, lengths, _ = pack_reads([encode_dna(s) for s in seqs])
    return seqs, codes, lengths


@pytest.mark.parametrize("k", [3, 15, 21])
def test_kmer_codes_equal_jax(k):
    _, codes, lengths = _batch()
    jc, jok = (np.asarray(a) for a in jk.kmer_codes(codes, lengths, k))
    tc, tok = (a.numpy() for a in tk.kmer_codes(T(codes), T(lengths), k))
    assert np.array_equal(tok, jok) and jok.any() and not jok.all()
    assert np.array_equal(tc, jc) and tc.dtype == jc.dtype
    jf, jr, jo = (np.asarray(a) for a in jk.kmer_codes_both_strands(codes, lengths, k))
    tf, tr, to = (a.numpy() for a in tk.kmer_codes_both_strands(T(codes), T(lengths), k))
    assert np.array_equal(tf, jf) and np.array_equal(tr, jr) and np.array_equal(to, jo)


@pytest.mark.parametrize("both", [True, False])
def test_sorted_counts_equal_jax_and_brute_force(both):
    seqs, codes, lengths = _batch()
    k = 15
    ju, jc, jn = jk.count_batch_kmers(codes, lengths, k, both_strands=both)
    n = int(jn)
    tu, tc, tn = tk.count_batch_kmers(T(codes), T(lengths), k, both_strands=both)
    assert tn == n == len(tu) == len(tc)
    assert np.array_equal(tu.numpy(), np.asarray(ju[:n]))
    assert np.array_equal(tc.numpy(), np.asarray(jc[:n]))
    got = {tk.decode_kmer(int(c), k): int(v) for c, v in zip(tu, tc)}
    assert got == dict(brute_force_kmers(seqs, k, both=both))
    # the JAX package's sorted-run lane gives the same distribution as the
    # counts' histogram (what KmersMap.count_distribution takes it from)
    js, _, jnu = jk.sort_batch_kmers(codes, lengths, k, both_strands=both)
    jd = np.asarray(jk.spectrum_from_sorted(js, max_count=5))
    td = np.bincount(np.minimum(tc.numpy(), 5), minlength=6)
    assert int(jnu) == n and np.array_equal(td, jd) and td.sum() == n


def test_encode_decode_kmer():
    assert tk.decode_kmer(tk.encode_kmer("ACGTACGTACGTACG"), 15) == "ACGTACGTACGTACG"
    assert tk.encode_kmer("acgtt") == jk.encode_kmer("acgtt")


def test_kmers_map_merge_lookup_saturation_equal_jax():
    out = []
    for cls in (JMap, TMap):
        m = cls(3)
        m.merge_batch(np.array([5, 9, 20]), np.array([2, 3, 1]))
        m.merge_batch(np.array([5, 21]), np.array([4, 7]))
        m.merge_batch(np.array([1]), np.array([30000]))
        m.merge_batch(np.array([1]), np.array([30000]))
        out.append((
            m.codes.tolist(), m.counts.tolist(), len(m), m.get_count(5),
            m.get_count(99), m.get_count("AAC"), m.lookup(np.array([5, 99, 21, 1])).tolist(),
            m.count_distribution(6).tolist(),
        ))
        m.filter_min_count(4)
        out[-1] += (m.codes.tolist(),)
    assert out[0] == out[1]
    assert out[1][1][0] == 32767  # saturates like short[4^k] (ref)


def test_kmers_map_device_runs_merge_like_host_runs():
    """Runs kept as tensors merge in one pass into the arrays that pairwise
    host merges give, an existing host part included, with early
    compaction switched on."""
    rng = np.random.default_rng(4)
    runs = []
    for _ in range(5):
        c = np.unique(rng.integers(0, 300, 120)).astype(np.int64)
        runs.append((c, rng.integers(1, 20000, len(c)).astype(np.int32)))
    host = JMap(5)
    for c, n in runs:
        host.merge_batch(c, n)
    dev = TMap(5)
    dev.COMPACT_AT = 150
    dev.merge_batch(*runs[0])
    for c, n in runs[1:]:
        dev.merge_batch_device(T(c), T(n))
    assert len(dev._pending) < 4  # compacted on the way
    assert len(dev) == len(host)
    assert np.array_equal(dev.codes, host.codes)
    assert np.array_equal(dev.counts, host.counts)
    assert dev.counts.max() == 32767 and dev.counts.dtype == np.int32


@pytest.fixture(scope="module")
def spectrum_files(tmp_path_factory):
    """A FASTA with a sequence longer than the extractor's window, one with
    an N, and a FASTQ of error-bearing reads over the first."""
    d = tmp_path_factory.mktemp("kmers")
    rng = np.random.default_rng(7)
    long_seq = decode_dna(rng.integers(0, 4, 70000).astype(np.int8))
    fa = d / "g.fa"
    fa.write_text(f">s1\n{long_seq}\n>s2\nACGTACGTACGTACGTACGTGGGGNACGTTGCATGCATGCAAA\n")
    fq = d / "r.fastq"
    with open(fq, "w") as fh:
        for i in range(400):
            a = int(rng.integers(0, 3000))
            s = list(long_seq[a : a + 80 + i % 30])
            if i % 7 == 0:
                s[40] = "ACGT"[(("ACGT".index(s[40])) + 1) % 4]
            fh.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * len(s)}\n")
    return d, str(fa), str(fq), long_seq


@pytest.mark.parametrize("only_forward", [False, True])
def test_extractor_outputs_equal_jax(spectrum_files, only_forward):
    d, fa, fq, long_seq = spectrum_files
    je = JExtractor(kmer_length=15, only_forward_strand=only_forward)
    te = TExtractor(kmer_length=15, only_forward_strand=only_forward, device="cpu")
    tag = "f" if only_forward else "b"
    je.run([fa, fq], str(d / f"j{tag}"))
    te.run([fa, fq], str(d / f"t{tag}"))
    jtxt = (d / f"j{tag}_kmers_distribution.txt").read_text()
    assert (d / f"t{tag}_kmers_distribution.txt").read_text() == jtxt
    with np.load(d / f"j{tag}_kmers.npz") as j, np.load(d / f"t{tag}_kmers.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            assert np.array_equal(t[key], j[key]), key
            assert t[key].dtype == j[key].dtype, key
    assert te.kmers_map.size == je.kmers_map.size > 60000
    dist = te.count_distribution()
    assert dist.sum() == te.kmers_map.size
    # chunking loses no window: the forward-only total of s1 is L - k + 1
    ex = TExtractor(kmer_length=15, only_forward_strand=True, device="cpu")
    ex.process_codes_list([encode_dna(long_seq)])
    assert int(ex.kmers_map.counts.sum()) == len(long_seq) - 15 + 1
    # text output and reload
    te.run([fa], str(d / f"t{tag}_txt"), text_output=True)
    je.run([fa], str(d / f"j{tag}_txt"), text_output=True)
    assert (d / f"t{tag}_txt_kmers.txt").read_text() == (d / f"j{tag}_txt_kmers.txt").read_text()
    back = TMap.load(str(d / f"t{tag}_kmers.npz"))
    assert back.k == 15 and np.array_equal(back.codes, te.kmers_map.codes)


def test_analyzer_equals_jax(spectrum_files):
    _, fa, fq, _ = spectrum_files
    je = JExtractor(kmer_length=15)
    je.process_file(fq)
    te = TExtractor(kmer_length=15, device="cpu")
    te.process_file(fq)
    ja, ta = JAnalyzer(je.kmers_map, max_count=40), TAnalyzer(te.kmers_map, max_count=40)
    assert np.array_equal(ta.distribution, ja.distribution)
    assert (ta.first_local_minimum, ta.local_mode, ta.average,
            ta.expected_assembly_length) == (
        ja.first_local_minimum, ja.local_mode, ja.average, ja.expected_assembly_length)
    q = np.array([0, 1, 3, 8, 40])
    assert np.array_equal(ta.rank_of_count(q), ja.rank_of_count(q))
    assert ta.is_error_count(0) == ja.is_error_count(0)


def test_mini_assembler_equals_jax():
    rng = np.random.default_rng(3)
    genome = decode_dna(rng.integers(0, 4, 300).astype(np.int8))
    je = JExtractor(kmer_length=9, only_forward_strand=True)
    je.process_codes_list([encode_dna(genome)])
    te = TExtractor(kmer_length=9, only_forward_strand=True, device="cpu")
    te.process_codes_list([encode_dna(genome)])
    ja, ta = JAssembler(je.kmers_map, 1), TAssembler(te.kmers_map, 1)
    src, dst = genome[50:59], genome[80:89]
    assert ta.assemble(src, dst, 19, 39, 44) == ja.assemble(src, dst, 19, 39, 44) == genome[50:89]
    assert ta.assemble(src, "AAAAAAAAA", 19, 39, 44) is None
    assert ta.assemble(src, None, 10, 30, 30) == ja.assemble(src, None, 10, 30, 30)


def _error_reads(seed=5):
    """tests/test_reads_processing.py's workload: clean 100 bp coverage of a
    4 kb sequence plus reads with a substitution, a 1-bp deletion and a
    1-bp insertion."""
    rng = np.random.default_rng(seed)
    genome = decode_dna(rng.integers(0, 4, 4000).astype(np.int8))
    reads = []
    for i in range(0, 3900, 20):
        for r in range(4):
            reads.append((f"c{i}_{r}", genome[i : i + 100]))
    sub = list(genome[1000:1100])
    sub[50] = {"A": "C", "C": "G", "G": "T", "T": "A"}[sub[50]]
    reads.append(("sub", "".join(sub)))
    reads.append(("del", genome[2000:2050] + genome[2051:2101]))
    reads.append(("ins", genome[3000:3050] + "A" + genome[3050:3099]))
    return genome, reads


@pytest.mark.parametrize("algorithm", ["debruijn", "snp"])
def test_corrected_reads_equal_jax(tmp_path, algorithm):
    genome, reads = _error_reads()
    fq = tmp_path / "in.fastq"
    with open(fq, "w") as fh:
        for name, s in reads:
            fh.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    jc = JCorrector(kmer_length=15, min_kmer_count=3, algorithm=algorithm)
    tc = TCorrector(kmer_length=15, min_kmer_count=3, algorithm=algorithm, device="cpu")
    jc.run(str(fq), str(tmp_path / "j.fastq"))
    tc.run(str(fq), str(tmp_path / "t.fastq"))
    jtxt = (tmp_path / "j.fastq").read_text()
    assert (tmp_path / "t.fastq").read_text() == jtxt
    assert (tc.corrected_errors, tc.corrected_reads) == (
        jc.corrected_errors, jc.corrected_reads)
    assert tc.corrected_reads >= 1
    lines = jtxt.splitlines()
    fixed = lines[lines.index("@sub") + 1]
    assert fixed == genome[1000:1100]
    # single reads through both, object in and object out
    for name, s in reads[-3:]:
        jr = jc.correct_read_debruijn(JRawRead(name, s, "I" * len(s)))
        tr = tc.correct_read_debruijn(TRawRead(name, s, "I" * len(s)))
        assert (tr.sequence, tr.qualities) == (jr.sequence, jr.qualities)


def test_cli_kmer_commands_equal_jax(spectrum_files, tmp_path):
    from ngsepcore_tpu.__main__ import main as jmain
    from ngsepcore_tpu_torch.__main__ import main as tmain

    _, fa, fq, _ = spectrum_files
    jmain(["KmersExtractor", "-k", "13", "-o", str(tmp_path / "j"), fa, fq])
    tmain(["--device", "cpu", "KmersExtractor", "-k", "13", "-o", str(tmp_path / "t"), fa, fq])
    assert (tmp_path / "t_kmers_distribution.txt").read_text() == (
        tmp_path / "j_kmers_distribution.txt").read_text()
    with np.load(tmp_path / "j_kmers.npz") as j, np.load(tmp_path / "t_kmers.npz") as t:
        for key in j.files:
            assert np.array_equal(t[key], j[key]), key
    jmain(["ReadsFileErrorsCorrector", "-m", "3", fq, str(tmp_path / "j.fastq")])
    tmain(["--device", "cpu", "ReadsFileErrorsCorrector", "-m", "3", fq,
           str(tmp_path / "t.fastq")])
    out = (tmp_path / "t.fastq").read_text()
    assert out == (tmp_path / "j.fastq").read_text()
    assert out != open(fq).read()  # some read was corrected
