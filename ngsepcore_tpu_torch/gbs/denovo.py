"""De-novo GBS: k-mer prefix read clustering + per-cluster variant calling.

Ref: src/ngsep/gbs/KmerPrefixReadsClusteringAlgorithm.java:313-355 (command
`DeNovoGBS`): cluster reads across samples by their 31-bp k-mer prefix
(DNAShortKmerClusterMap), min cluster depth = max(#samples, default), max =
100x#samples (:319-321), per-cluster consensus + column-wise variant
calling with CountsHelper; ReadCluster.java (consensus/depth),
ProcessClusterVCFTask.java (per-cluster VCF records).

Counterpart of ngsepcore_tpu/gbs/denovo.py, which loops in Python over every
read and over every variable column, sample and read of every cluster.
Here the work that grows with reads x columns runs on the caller's device:

- every read with a 31-base prefix free of N gets its prefix as an exact
  base-4 int64 code, and one stable sort groups the reads into clusters
  (equal codes keep sample-then-read order);
- the kept clusters' reads form one (reads, L) int8 code matrix (-1 past a
  read's end) and a quality matrix; symbol counts per (cluster, column)
  give the consensus (the first of the most frequent of 5 symbols) and the
  variable columns;
- each (cluster, variable column, sample) cell's log-conditional (4, 4)
  matrix is the sum of its usable reads' contributions C[a, q] in read
  order, one add a read: the reads of a rank within their cell are added
  to all cells at once, so the sums have the same bits on every IEEE
  device and equal the JAX package's loop.

Each cell's genotype is then decided on the host with numpy over all cells
at once, in the JAX package's own ufuncs and order (decide_cells): numpy's
power and log10 differ from torch's in the last bit on some inputs, and a
genotype quality round(-10 log10(1 - best)) can turn on that bit.  The
records equal the JAX package's.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..core.sequences import RawRead, _ENC_TABLE
from ..io.fasta import _open_text
from ..io.fastq import FastqFileReader
from ..kernels.genotyping import HET_RATE_DIPLOID, MAX_BASE_QS, snv_contribution_table
from ..math.phred import MAX_PHRED
from ..utils import profiling
from ..variants.model import CalledGenomicVariant, TYPE_BIALLELIC_SNV
from ..vcf.io import VCFFileWriter, VCFRecord

PREFIX_LENGTH = 31  # ref: DNAShortKmerClusterMap k<=31
# the most (read, variable column) entries a pass of the per-cell sums takes
ENTRY_CHUNK = 1 << 25
# -10 log10(p) values this close to a rounding boundary k + 0.5 take
# math.log10 (the JAX package's phred_score) in place of np.log10
PHRED_RECHECK = 1e-9
_PAIRS = [(i, j) for i in range(4) for j in range(i, 4)]


@dataclass
class GBSReads:
    """The reads of every sample as dense host arrays, sample by sample in
    file order: codes (N, L) int8 (-1 past each read's end), phred
    qualities (N, L) int8 (0 past the end), lengths (N,) and the sample
    index of each read (N,)."""

    codes: np.ndarray
    quals: np.ndarray
    lengths: np.ndarray
    samples: np.ndarray

    @staticmethod
    def from_rows(rows) -> "GBSReads":
        """From (sample, codes, phred) rows, phred as long as its codes."""
        n = len(rows)
        lengths = np.array([len(c) for _, c, _ in rows], dtype=np.int64)
        L = int(lengths.max(initial=0))
        codes = np.full((n, L), -1, np.int8)
        quals = np.zeros((n, L), np.int8)
        for i, (_, c, q) in enumerate(rows):
            codes[i, : len(c)] = c
            quals[i, : len(c)] = q
        samples = np.array([s for s, _, _ in rows], dtype=np.int64)
        return GBSReads(codes, quals, lengths, samples)

    @staticmethod
    def concatenate(parts: list["GBSReads"]) -> "GBSReads":
        L = max([p.codes.shape[1] for p in parts] + [0])
        pad = lambda a, v: np.pad(a, ((0, 0), (0, L - a.shape[1])), constant_values=v)
        return GBSReads(
            np.concatenate([pad(p.codes, -1) for p in parts]) if parts else np.zeros((0, 0), np.int8),
            np.concatenate([pad(p.quals, 0) for p in parts]) if parts else np.zeros((0, 0), np.int8),
            np.concatenate([p.lengths for p in parts]) if parts else np.zeros(0, np.int64),
            np.concatenate([p.samples for p in parts]) if parts else np.zeros(0, np.int64),
        )


def _raw_row(sample: int, r: RawRead):
    """(sample, codes, phred) of a read as the JAX package reads it:
    its phred qualities, or 30 everywhere without a quality string."""
    c = r.codes
    q = r.phred if r.qualities else np.full(len(r), 30, np.int8)
    q = np.asarray(q[: len(c)], np.int8)
    if len(q) < len(c):
        q = np.concatenate([q, np.zeros(len(c) - len(q), np.int8)])
    return sample, c, q


def reads_from_samples(reads_per_sample: list[list[RawRead]]) -> GBSReads:
    return GBSReads.from_rows(
        [_raw_row(si, r) for si, reads in enumerate(reads_per_sample) for r in reads])


def read_fastq_sample(path: str, sample: int) -> GBSReads:
    """One FASTQ file's reads.  A file of plain four-line records with
    qualities as long as their sequences is parsed in bulk with numpy; any
    other goes through FastqFileReader read by read (same result)."""
    with _open_text(path) as fh:
        lines = fh.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    seqs, quals = lines[1::4], lines[3::4]
    regular = (
        len(lines) % 4 == 0
        and all(h.startswith("@") for h in lines[0::4])
        and all(p.startswith("+") for p in lines[2::4])
        and all(len(s) == len(q) for s, q in zip(seqs, quals))
    )
    if not regular:
        return GBSReads.from_rows([_raw_row(sample, r) for r in FastqFileReader(path)])
    n = len(seqs)
    lengths = np.fromiter(map(len, seqs), dtype=np.int64, count=n)
    L = int(lengths.max(initial=0))
    inside = np.arange(L)[None, :] < lengths[:, None]
    codes = np.full((n, L), -1, np.int8)
    codes[inside] = _ENC_TABLE[np.frombuffer("".join(seqs).encode("ascii"), np.uint8)]
    phred = np.zeros((n, L), np.int8)
    raw = np.frombuffer("".join(quals).encode("ascii"), np.uint8)
    phred[inside] = (raw.astype(np.int16) - 33).astype(np.int8)
    return GBSReads(codes, phred, lengths, np.full(n, sample, np.int64))


@dataclass
class ReadCluster:
    cluster_id: int
    reads: list[np.ndarray]
    samples: list[int]
    quals: list[np.ndarray]

    @property
    def depth(self) -> int:
        return len(self.reads)


def _pairwise16(p: np.ndarray) -> np.ndarray:
    """Row sums of (n, 16) in numpy's pairwise order for 16 terms (the
    order of a (4, 4) array's p.sum()): r[j] = p[j] + p[j + 8], then
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))."""
    r = p[:, :8] + p[:, 8:]
    return ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))


def phred_scores(p: np.ndarray) -> np.ndarray:
    """math/phred.phred_score over an array: round(-10 log10(p)) (half to
    even, as Python's round), 255 at p <= 0, 0 at p >= 1, at most 255.
    np.log10 is within a few ulps of math.log10, so only values within
    PHRED_RECHECK of a rounding boundary can round otherwise: those take
    math.log10."""
    inside = (p > 0) & (p < 1)
    v = np.zeros(p.shape)
    v[inside] = -10.0 * np.log10(p[inside])
    near = np.flatnonzero(inside & (np.abs(v - (np.floor(v) + 0.5)) < PHRED_RECHECK))
    for i in near:
        v[i] = -10.0 * math.log10(float(p[i]))
    score = np.where(p <= 0, MAX_PHRED, np.where(p >= 1, 0, np.minimum(np.rint(v), MAX_PHRED)))
    return score.astype(np.int64)


def decide_cells(logcond: np.ndarray, ref: np.ndarray, prior: np.ndarray):
    """Genotype of each cell from its (n, 16) log-conditionals (row-major
    (4, 4)) and its column's consensus base `ref`, in the JAX package's
    per-cell arithmetic (denovo.py:153-165) over all cells at once:
    (first allele, second allele, GQ before the no-read rule, best
    posterior)."""
    ev = logcond + prior.reshape(1, 16)
    rel = ev - ev.max(axis=1, keepdims=True)
    p = np.where(rel < -20, 0.0, 10.0 ** rel)
    s = _pairwise16(p)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        post = np.where(s > 0, p / np.where(s > 0, s, 1.0), p)
    rows = np.arange(len(ref))
    best = post[rows, ref * 5]
    bi = ref.copy()
    bj = ref.copy()
    for i2, j2 in _PAIRS:
        prob = post[:, i2 * 4 + j2] + post[:, j2 * 4 + i2] if i2 != j2 else post[:, i2 * 5]
        upd = prob > best + 0.01
        best = np.where(upd, prob, best)
        bi = np.where(upd, i2, bi)
        bj = np.where(upd, j2, bj)
    q = 1 - best
    gq = phred_scores(np.where(q > 0.0, q, 0.0))
    return bi, bj, gq, best


class KmerPrefixReadsClusteringAlgorithm:
    def __init__(
        self,
        min_cluster_depth: int | None = None,
        max_cluster_depth_per_sample: int = 100,
        min_quality: int = 40,
        heterozygosity_rate: float = HET_RATE_DIPLOID,
        *,
        device,
    ):
        self.min_cluster_depth = min_cluster_depth
        self.max_cluster_depth_per_sample = max_cluster_depth_per_sample
        self.min_quality = min_quality
        self.heterozygosity_rate = heterozygosity_rate
        self.device = torch.device(device)
        self._contribution = snv_contribution_table(4, 0.5)
        het = heterozygosity_rate
        self._prior = np.where(
            np.eye(4, dtype=bool), np.log10((1 - het) / 4), np.log10(het / 12)
        )
        # bytes of log-conditionals brought to the host by the last call
        self.host_bytes = 0

    @contextmanager
    def _stage(self, name):
        """A profiled stage that ends with the device's queue drained."""
        with profiling.stage(name):
            yield
            if profiling.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def prefix_codes(self, reads: GBSReads):
        """(valid (N,) bool, code (N,) int64) on the device: reads whose first
        31 bases are A, C, G or T, and those bases as a base-4 number."""
        codes = torch.as_tensor(reads.codes, device=self.device)
        lengths = torch.as_tensor(reads.lengths, device=self.device)
        if codes.shape[1] < PREFIX_LENGTH:
            z = torch.zeros(codes.shape[0], dtype=torch.int64, device=self.device)
            return z.bool(), z
        head = codes[:, :PREFIX_LENGTH].long()
        valid = (lengths >= PREFIX_LENGTH) & ((head >= 0) & (head < 4)).all(dim=1)
        code = torch.zeros(codes.shape[0], dtype=torch.int64, device=self.device)
        for k in range(PREFIX_LENGTH):
            code = code * 4 + head[:, k].clamp(min=0)
        return valid, code

    def _cluster_layout(self, reads: GBSReads, n_samples: int):
        """(read rows of the kept clusters in cluster order, (K,) first row
        of each kept cluster in that order) on the device; cluster k is
        Cluster_{k+1}."""
        valid, code = self.prefix_codes(reads)
        rows = torch.nonzero(valid)[:, 0]
        srt, perm = torch.sort(code[rows], stable=True)
        rows = rows[perm]
        n = len(rows)
        if n == 0:
            e = torch.zeros(0, dtype=torch.int64, device=self.device)
            return e, e
        first = torch.ones(n, dtype=torch.bool, device=self.device)
        first[1:] = srt[1:] != srt[:-1]
        starts = torch.nonzero(first)[:, 0]
        depth = torch.diff(starts, append=torch.tensor([n], device=self.device))
        min_depth = self.min_cluster_depth or max(n_samples, 5)
        max_depth = self.max_cluster_depth_per_sample * n_samples
        keep = (depth >= min_depth) & (depth <= max_depth)
        cl_of = torch.cumsum(first.long(), dim=0) - 1
        kept_rows = rows[keep[cl_of]]
        kept_depth = depth[keep]
        kept_starts = torch.cumsum(kept_depth, dim=0) - kept_depth
        return kept_rows, kept_starts

    def cluster_reads(self, reads_per_sample: list[list[RawRead]]) -> list[ReadCluster]:
        reads = reads_from_samples(reads_per_sample)
        rows, starts = self._cluster_layout(reads, len(reads_per_sample))
        rows, starts = rows.cpu().numpy(), starts.cpu().numpy()
        ends = np.append(starts[1:], len(rows))
        out = []
        for k, (s, e) in enumerate(zip(starts, ends)):
            rs = rows[s:e]
            lens = reads.lengths[rs]
            out.append(ReadCluster(
                cluster_id=k + 1,
                reads=[reads.codes[r, :n] for r, n in zip(rs, lens)],
                samples=[int(x) for x in reads.samples[rs]],
                quals=[reads.quals[r, :n] for r, n in zip(rs, lens)],
            ))
        return out

    def call_cluster_variants(self, cluster: ReadCluster, n_samples: int) -> list[VCFRecord]:
        reads = GBSReads.from_rows(list(zip(cluster.samples, cluster.reads,
                                            [q[: len(r)] for q, r in zip(cluster.quals,
                                                                          cluster.reads)])))
        rows = torch.arange(len(cluster.reads), device=self.device)
        starts = torch.zeros(1, dtype=torch.int64, device=self.device)
        return self._call(reads, rows, starts, [cluster.cluster_id], n_samples)

    def call_variants(self, reads: GBSReads, n_samples: int,
                      n_files: int | None = None) -> list[VCFRecord]:
        """Records of every kept cluster of `reads`, clusters in order.  The
        cluster depth limits count `n_files` samples (default n_samples),
        as the JAX package's run counts its files."""
        with self._stage("gbs.sort"):
            rows, starts = self._cluster_layout(reads, n_files or n_samples)
        return self._call(reads, rows, starts, None, n_samples)

    # ------------------------------------------------------------------
    def _call(self, reads: GBSReads, rows, starts, cluster_ids, n_samples):
        """Records of the clusters whose reads are reads[rows[starts[k]:
        starts[k+1]]] (cluster ids `cluster_ids`, or k + 1)."""
        dev = self.device
        self.host_bytes = 0
        K = len(starts)
        if K == 0:
            return []
        with self._stage("gbs.clusters"):
            R = len(rows)
            M = torch.as_tensor(reads.codes, device=dev)[rows]
            Q = torch.as_tensor(reads.quals, device=dev)[rows].clamp(max=MAX_BASE_QS)
            smp = torch.as_tensor(reads.samples, device=dev)[rows]
            L = M.shape[1]
            depth = torch.diff(starts, append=torch.tensor([R], device=dev))
            cl = torch.repeat_interleave(torch.arange(K, device=dev), depth)
            counts = torch.zeros((K, L, 5), dtype=torch.int32, device=dev)
            for sym in range(5):
                counts[:, :, sym].index_add_(0, cl, (M == sym).to(torch.int32))
            ok = ((M >= 0) & (M < 4) & (Q > 3)).to(torch.int32)
            ok_cnt = torch.zeros((K, L), dtype=torch.int32, device=dev).index_add_(0, cl, ok)
            del ok
            top = counts.max(dim=2, keepdim=True).values
            sym5 = torch.arange(5, dtype=torch.int32, device=dev)
            cons = torch.where(counts == top, sym5, 5).amin(dim=2)  # first most frequent
            differ = counts.sum(dim=2) - counts.gather(2, cons.long()[:, :, None])[:, :, 0]
            col_ok = torch.arange(L, device=dev)[None, :] >= PREFIX_LENGTH
            variable = col_ok & (cons < 4) & (differ > 0) & (ok_cnt > 0)
            vc, vj = torch.nonzero(variable, as_tuple=True)
            v_cons = cons[vc, vj]
            del counts, ok_cnt, variable
            Ct = torch.as_tensor(self._contribution, device=dev).reshape(4 * (MAX_BASE_QS + 1), 16)
            vc_h, vj_h, cons_h = (t.cpu().numpy() for t in (vc, vj, v_cons))
            depth_h = depth.cpu().numpy()
        out: list[VCFRecord] = []
        V = len(vc_h)
        lo = 0
        while lo < V:
            # columns of this pass: their entries (one a read of the cluster)
            # fit ENTRY_CHUNK
            ent = np.cumsum(depth_h[vc_h[lo:]])
            hi = lo + max(1, int(np.searchsorted(ent, ENTRY_CHUNK, side="right")))
            with self._stage("gbs.sums"):
                acc, cell_depth = self._cell_sums(
                    M, Q, smp, starts, depth, vc[lo:hi], vj[lo:hi], Ct, n_samples)
            with self._stage("gbs.fetch"):
                logcond, cell_depth = acc.cpu().numpy(), cell_depth.cpu().numpy()
                self.host_bytes += logcond.nbytes
            with self._stage("gbs.decide"):
                out.extend(self._decide(
                    logcond, cell_depth, vc_h[lo:hi], vj_h[lo:hi], cons_h[lo:hi],
                    cluster_ids, n_samples))
            lo = hi
        return out

    def _cell_sums(self, M, Q, smp, starts, depth, vc, vj, Ct, S):
        """(V*S, 16) float64 log-conditionals of the (column, sample) cells
        of the variable columns (vc, vj) and their usable-read counts, on
        the device.  A cell adds its reads' C[a, q] in read order, one add a
        read: all cells add their rank-k read in the same pass."""
        dev = M.device
        V = len(vc)
        rep = depth[vc]
        v_e = torch.repeat_interleave(torch.arange(V, device=dev), rep)
        first = torch.cumsum(rep, dim=0) - rep
        r_e = starts[vc][v_e] + torch.arange(len(v_e), device=dev) - first[v_e]
        j_e = vj[v_e]
        a = M[r_e, j_e].long()
        q = Q[r_e, j_e].long()
        s_e = smp[r_e]
        ok = (a >= 0) & (a < 4) & (q > 3) & (s_e < S)
        cell = (v_e * S + s_e)[ok]
        aq = (a * (MAX_BASE_QS + 1) + q)[ok]
        del v_e, r_e, j_e, a, q, s_e, ok
        # entries are in (column, read) order: a stable sort by cell keeps
        # each cell's reads in read order
        cell, order = torch.sort(cell, stable=True)
        aq = aq[order]
        idx = torch.arange(len(cell), device=dev)
        head = torch.ones(len(cell), dtype=torch.bool, device=dev)
        head[1:] = cell[1:] != cell[:-1]
        rank = idx - torch.cummax(torch.where(head, idx, 0), dim=0).values
        by_rank = torch.sort(rank, stable=True).indices
        per_rank = torch.bincount(rank).cpu().tolist() if len(rank) else []
        acc = torch.zeros((V * S, 16), dtype=torch.float64, device=dev)
        at = 0
        for n in per_rank:
            sel = by_rank[at : at + n]
            c = cell[sel]
            acc[c] = acc[c] + Ct[aq[sel]]
            at += n
        return acc, torch.bincount(cell, minlength=V * S)

    def _decide(self, logcond, cell_depth, vc, vj, cons, cluster_ids, S):
        """Host decision of every cell, then the records of the columns that
        pass (denovo.py:153-196)."""
        V = len(vc)
        ref = np.repeat(cons.astype(np.int64), S)
        bi = np.empty(V * S, np.int64)
        bj = np.empty(V * S, np.int64)
        gq = np.zeros(V * S, np.int64)
        has = cell_depth > 0
        got = decide_cells(logcond[has], ref[has], self._prior)
        bi[has], bj[has], gq[has] = got[:3]
        # a cell without reads decides on the prior alone; its GQ is 0
        none = decide_cells(np.zeros((4, 16)), np.arange(4), self._prior)
        bi[~has], bj[~has] = none[0][ref[~has]], none[1][ref[~has]]
        bi, bj, gq = (x.reshape(V, S) for x in (bi, bj, gq))
        ref = ref.reshape(V, S)
        nonref = (bi != ref) | (bj != ref)
        g = np.where(nonref, gq, 0)
        vqs = g.max(axis=1)
        first = g.argmax(axis=1)
        keep = np.flatnonzero((vqs > 0) & (vqs >= self.min_quality))
        cell_depth = cell_depth.reshape(V, S)
        out = []
        for v in keep:
            f = first[v]
            c0 = int(cons[v])
            alt = int(bi[v, f] if bi[v, f] != c0 else bj[v, f])
            cid = cluster_ids[vc[v]] if cluster_ids is not None else int(vc[v]) + 1
            alleles = ["ACGT"[c0], "ACGT"[alt]]
            calls = []
            for si in range(S):
                d = int(cell_depth[v, si])
                cgv = CalledGenomicVariant(
                    sequence_name=f"Cluster_{cid}",
                    first=int(vj[v]) + 1,
                    alleles=alleles,
                    variant_type=TYPE_BIALLELIC_SNV,
                    quality=int(vqs[v]),
                    sample_id=str(si),
                    genotype_quality=int(gq[v, si]) if d > 0 else 0,
                    total_read_depth=d,
                )
                idxs = []
                for a in sorted({int(bi[v, si]), int(bj[v, si])}):
                    if a == c0:
                        idxs.append(0)
                    elif a == alt:
                        idxs.append(1)
                if idxs and d > 0:
                    cgv.indexes_called_alleles = idxs
                calls.append(cgv)
            out.append(VCFRecord(variant=calls[0], calls=calls))
        return out

    # ------------------------------------------------------------------
    def run(
        self, fastq_files: list[str], sample_ids: list[str], output_prefix: str
    ) -> int:
        with self._stage("gbs.read"):
            reads = GBSReads.concatenate(
                [read_fastq_sample(p, si) for si, p in enumerate(fastq_files)])
        records = self.call_variants(reads, len(sample_ids), len(fastq_files))
        with self._stage("gbs.write"):
            with VCFFileWriter(output_prefix + ".vcf", sample_ids) as w:
                for rec in records:
                    w.write(rec)
        return len(records)
