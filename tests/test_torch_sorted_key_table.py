"""The sorted-key seed table (the MinimizerTable layout for references of
more than MAX_BUCKETIZED_CODES distinct minimizers) against the JAX
package on the CPU.  The switch is forced low on both packages' classes, so
a 30 kb genome takes the layout: its five device arrays, the seeds of
seed_cluster_screen, the fused pipeline's VCF records and the classic
aligner's SAM lines must equal JAX's exactly.  A synthetic table with
colliding lookup hashes must cull the same codes as JAX's, and a query of a
culled code must get no seeds; on a table without collisions the sorted-key
seeds equal the bucket seeds."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.call.fused_pipeline import AlignCallPipeline as JPipeline
from ngsepcore_tpu.call.single_sample import SingleSampleVariantsDetector as JDetector
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.index.minimizer_table import MinimizerTable as JTable
from ngsepcore_tpu.kernels import seeding as js
from ngsepcore_tpu.simulation.individual_simulator import SingleIndividualSimulator
from ngsepcore_tpu.simulation.reads_simulator import SingleReadsSimulator
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline as TPipeline
from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector as TDetector
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead
from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable as TTable
from ngsepcore_tpu_torch.index.minimizer_table import SortedKeyTable
from ngsepcore_tpu_torch.kernels import seeding as ts
from ngsepcore_tpu_torch.kernels.kmers import rc_code_int64
from ngsepcore_tpu_torch.kernels.minimizers import lookup_hash32
from test_fused_pipeline import _record_key
from test_torch_seeding import _reads

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)

T = torch.from_numpy
FORCED = 1 << 10  # below the 30 kb genome's ~2,800 distinct codes
ARRAYS = ("keys", "ver_hi", "ver_lo", "row_offsets", "entry_packed")


def _forced(mp):
    mp.setattr(JTable, "MAX_BUCKETIZED_CODES", FORCED)
    mp.setattr(TTable, "MAX_BUCKETIZED_CODES", FORCED)


def _genome_codes(seed=8):
    """30 kb in two sequences, a 600 bp segment in three copies (reads
    with several candidates) and one N base."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 18000).astype(np.int8)
    b = rng.integers(0, 4, 12000).astype(np.int8)
    seg = a[2000:2600].copy()
    a[11000:11600] = seg
    b[4000:4600] = seg
    b[7000] = 4
    return {"chrA": a, "chrB": b}


def _sam(per_read):
    return ["\t".join(a.to_sam_fields()) for alns in per_read for a in alns]


def _align_all(aligner, reads, batch=1024):
    out = []
    for i in range(0, len(reads), batch):
        out.extend(aligner.align_batch(reads[i : i + batch]))
    return out


@pytest.fixture(scope="module")
def case():
    """Both packages' tables, fused records and classic SAM lines on the
    30 kb genome with the sorted-key layout forced: 3,000 reads of 100 bp
    from a diploid individual with SNVs and indels."""
    codes = _genome_codes()
    jl, tl = JQSL(), TQSL()
    for name, c in codes.items():
        jl.add(JQS(name=name, codes=c.copy()))
        tl.add(TQS(name=name, codes=c.copy()))
    jg, tg = JGenome(jl), TGenome(tl)
    sim = SingleIndividualSimulator(jg, snv_rate=0.002, indel_rate=0.0005, seed=5)
    sim.simulate()
    reads = []
    for h, hg in enumerate(sim.build_haplotype_genomes()):
        reads.extend(
            SingleReadsSimulator(
                hg, read_length=100, substitution_error_rate=0.004, seed=20 + h
            ).simulate(1500)
        )
    treads = [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
              for r in reads]
    with pytest.MonkeyPatch.context() as mp:
        _forced(mp)
        jtab = JTable.build_from_genome(jg)
        ttab = TTable.build_from_genome(tg, device="cpu")
        jarr = jtab.device_arrays()
        tarr = ttab.device_arrays("cpu")
        jrec = JPipeline(
            jg, aligner=JAligner(jg, table=jtab),
            detector=JDetector(jg, sample_id="s1"), batch_size=1024,
        ).run_reads(reads)
        trec = TPipeline(
            tg, aligner=TAligner(tg, table=ttab, device="cpu"),
            detector=TDetector(tg, sample_id="s1"), batch_size=1024, device="cpu",
        ).run_reads(treads)
        jsam = _sam(_align_all(JAligner(jg, table=jtab), reads))
        tsam = _sam(_align_all(TAligner(tg, table=ttab, device="cpu"), treads))
    return dict(
        codes=codes, jg=jg, tg=tg, jtab=jtab, ttab=ttab, jarr=jarr, tarr=tarr,
        jrec=jrec, trec=trec, jsam=jsam, tsam=tsam,
    )


def test_switch_is_the_reference_value():
    assert TTable.MAX_BUCKETIZED_CODES == JTable.MAX_BUCKETIZED_CODES == 1 << 24


def test_sorted_key_arrays_equal_jax(case):
    jarr, tarr = case["jarr"], case["tarr"]
    assert isinstance(tarr, SortedKeyTable)
    assert np.asarray(jarr[0]).ndim == 1  # JAX took its sorted-key layout too
    assert tarr.keys.dtype == torch.int64
    for name, j in zip(ARRAYS, jarr):
        j = np.asarray(j)
        t = getattr(tarr, name).numpy()
        assert t.shape == j.shape, name
        assert np.array_equal(t, j.astype(t.dtype)), name
    assert np.all(np.diff(tarr.keys.numpy()) > 0)  # sorted, no shared key
    assert len(tarr.keys) > FORCED


@pytest.mark.parametrize("packed,const_len", [(True, None), (False, None), (True, 100)])
def test_sorted_key_seeds_equal_jax(case, packed, const_len):
    rng = np.random.default_rng(6)
    jg, tg = case["jg"], case["tg"]
    concat = np.concatenate(list(case["codes"].values()))
    codes, lengths, pq = _reads(rng, concat)
    if const_len is not None:
        lengths[:] = const_len
        codes[:, const_len:] = 4
        pq = (codes.view(np.uint8) & 7) | (pq & 0xF8)
    x = pq if packed else codes
    kw = dict(k=25, window=20, genome_len=jg.total_length, const_len=const_len,
              genome_has_n=jg.has_n)
    j = js.seed_cluster_screen(x, lengths, *case["jarr"], *jg.device_packed(), **kw)
    t = ts.seed_cluster_screen(T(x), T(lengths), case["tarr"], *tg.device_packed("cpu"), **kw)
    for key in j:
        assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
    assert (np.asarray(j["weight"])[:, 0] > 2).mean() > 0.8


def test_sorted_key_fused_records_equal_jax(case):
    jk = [_record_key(r) for r in case["jrec"]]
    tk = [_record_key(r) for r in case["trec"]]
    assert len(jk) > 10
    assert any(len(k[2][0]) != len(k[2][1]) for k in jk)  # indel records
    assert tk == jk


def test_sorted_key_classic_sam_equal_jax(case):
    assert len(case["jsam"]) > 2500
    assert case["tsam"] == case["jsam"]


def test_sorted_key_seeds_equal_bucket_seeds_without_collision(case):
    ttab, tg = case["ttab"], case["tg"]
    sorted_key = case["tarr"]
    assert len(sorted_key.keys) == len(ttab.unique_codes)  # nothing culled
    buckets = torch.from_numpy(ttab._build_bucketized())
    rng = np.random.default_rng(9)
    concat = np.concatenate(list(case["codes"].values()))
    codes, lengths, pq = _reads(rng, concat)
    kw = dict(k=25, window=20, genome_len=tg.total_length, genome_has_n=tg.has_n)
    a = ts.seed_cluster_screen(T(pq), T(lengths), sorted_key, *tg.device_packed("cpu"), **kw)
    b = ts.seed_cluster_screen(T(pq), T(lengths), buckets, *tg.device_packed("cpu"), **kw)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _code_bases(code, k=25):
    """The k bases (forward strand) of a 2-bit code, first base highest."""
    return np.array([(code >> (2 * (k - 1 - j))) & 3 for j in range(k)], np.int8)


K, LO_BITS, GLEN = 25, 30, 20_000


@pytest.fixture(scope="module")
def colliding():
    """2^18 random canonical codes, sorted, and those of them that share a
    lookup hash with another (~n^2 / 2^33 = 8 pairs expected)."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 1 << (2 * K), 1 << 18, dtype=np.int64)
    canon = np.unique(np.minimum(raw, rc_code_int64(raw, K)))
    h = lookup_hash32(
        T((canon >> LO_BITS).astype(np.int32)),
        T((canon & ((1 << LO_BITS) - 1)).astype(np.int32)),
    ).numpy()
    hv, hc = np.unique(h, return_counts=True)
    return canon, canon[np.isin(h, hv[hc > 1])]


def _both_tables(codes, seed=12):
    """Both packages' tables over `codes`, 1-3 random entries a code, and
    their device arrays (the arrays must be equal)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 4, len(codes))
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    pos = rng.integers(0, GLEN - 200, int(offs[-1])).astype(np.int64)
    strand = rng.integers(0, 2, int(offs[-1])).astype(np.int8)
    ttab = TTable.from_arrays(K, 20, 500, codes, offs, pos, strand)
    jtab = JTable(K, 20, 500)
    jtab.unique_codes, jtab.row_offsets = codes, offs
    jtab.entry_pos, jtab.entry_strand = pos, strand
    jarr, tarr = jtab.device_arrays(), ttab.device_arrays("cpu")
    assert isinstance(tarr, SortedKeyTable)
    for name, j in zip(ARRAYS, jarr):
        t = getattr(tarr, name).numpy()
        assert np.array_equal(t, np.asarray(j).astype(t.dtype)), name
    return jarr, tarr


def _screen(queries, tarr, jarr=None):
    """seed_cluster_screen of one 25-base read a query code (its only
    k-mer, so its minimizer) in the port and, given its arrays, in the
    JAX package, whose outputs must then be equal."""
    reads = np.full((len(queries), 32), 4, np.int8)
    for i, c in enumerate(queries):
        reads[i, :K] = _code_bases(int(c), K)
    lengths = np.full(len(queries), K, np.int32)
    genome = np.random.default_rng(13).integers(0, 4, GLEN).astype(np.int8)
    tl = TQSL()
    tl.add(TQS(name="chr1", codes=genome.copy()))
    kw = dict(k=K, window=20, genome_len=GLEN, genome_has_n=False)
    t = ts.seed_cluster_screen(
        T(reads), T(lengths), tarr, *TGenome(tl).device_packed("cpu"), **kw
    )
    if jarr is not None:
        jl = JQSL()
        jl.add(JQS(name="chr1", codes=genome.copy()))
        j = js.seed_cluster_screen(reads, lengths, *jarr, *JGenome(jl).device_packed(), **kw)
        for key in j:
            assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
    return t


def test_colliding_hashes_culled_like_jax(monkeypatch, colliding):
    """Both codes of each shared lookup hash are culled, in both packages.
    A read that is one such code gets no seeds, nor does one of an absent
    code whose hash lands on a kept code's row with the same low half; a
    read of a kept code does."""
    _forced(monkeypatch)
    canon, colliding = colliding
    assert len(colliding) >= 4
    jarr, tarr = _both_tables(canon)
    k, lo_bits = K, LO_BITS
    kept = (tarr.ver_hi.numpy().astype(np.int64) << lo_bits) | tarr.ver_lo.numpy()
    j_kept = (np.asarray(jarr[1]).astype(np.int64) << lo_bits) | np.asarray(jarr[2])
    assert np.array_equal(kept, j_kept)
    culled = np.setdiff1d(canon, kept)
    assert np.array_equal(np.sort(culled), np.sort(colliding))

    # absent codes that share a kept code's low half and whose hash lands
    # on that code's row: only the high half's compare turns them away
    keys = tarr.keys.numpy()
    his = np.arange(1 << (2 * k - lo_bits), dtype=np.int64)
    decoys = []
    for row, x in enumerate(kept):  # kept codes are in key order
        x_lo = x & ((1 << lo_bits) - 1)
        hq = lookup_hash32(T(his.astype(np.int32)), T(np.full(len(his), x_lo, np.int32)))
        q = (his << lo_bits) | x_lo
        q = q[(np.searchsorted(keys, hq.numpy()) == row) & (q != x)]
        decoys.extend(q[(q <= rc_code_int64(q, k)) & ~np.isin(q, canon)][:1])
        if len(decoys) == 4:
            break
    assert len(decoys) == 4

    nd = len(colliding) + len(decoys)
    queries = np.concatenate(
        [colliding, decoys, canon[~np.isin(canon, colliding)][:16]]
    ).astype(np.int64)
    t = _screen(queries, tarr, jarr)
    w = t["weight"].numpy()
    assert np.all(w[:nd] == 0)  # a culled code or a decoy: no seed
    assert np.all(t["pred_start"].numpy()[:nd] == ts.BIG32)
    assert np.all(w[nd:, 0] > 0)  # a kept code seeds


def test_every_code_culled_gives_no_seeds(monkeypatch, colliding):
    """A table whose codes all share their hashes keeps no key (U = 0), in
    both packages, and no query finds a seed in the port.  (The JAX
    package's lookup gathers from the empty entry array there and raises.)"""
    monkeypatch.setattr(JTable, "MAX_BUCKETIZED_CODES", 1)
    monkeypatch.setattr(TTable, "MAX_BUCKETIZED_CODES", 1)
    _, colliding = colliding
    _, tarr = _both_tables(colliding)
    assert len(tarr.keys) == 0 and len(tarr.entry_packed) == 0
    t = _screen(colliding, tarr)
    assert np.all(t["weight"].numpy() == 0)
    assert np.all(t["pred_start"].numpy() == ts.BIG32)


def test_build_across_chunk_seams_equals_jax():
    """A sequence longer than the build's 2^20-base chunk is read in
    overlapping rows; the entries found twice at a seam are dropped once,
    and the table equals the JAX package's (which drops them with
    np.unique)."""
    rng = np.random.default_rng(21)
    a = rng.integers(0, 4, (1 << 20) + 150_000).astype(np.int8)
    b = rng.integers(0, 4, 40_000).astype(np.int8)
    a[300_000:301_000] = a[1_100_000:1_101_000]  # a repeat across the seam
    jl, tl = JQSL(), TQSL()
    for name, c in (("chrA", a), ("chrB", b)):
        jl.add(JQS(name=name, codes=c.copy()))
        tl.add(TQS(name=name, codes=c.copy()))
    jtab = JTable.build_from_genome(JGenome(jl))
    ttab = TTable.build_from_genome(TGenome(tl), device="cpu")
    for key in ("unique_codes", "row_offsets", "entry_pos", "entry_strand"):
        assert np.array_equal(getattr(ttab, key), getattr(jtab, key)), key
    assert np.any(np.diff(ttab.row_offsets) > 1)
