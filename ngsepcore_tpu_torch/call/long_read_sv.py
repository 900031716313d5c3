"""Long-read structural variant detection from intra/inter-alignment
signatures.

Ref: src/ngsep/discovery/LongReadStructuralVariantDetector.java (signature
collection :124-300, cluster->variant :346-400, Bayesian genotyping
:448-650, run flow :716-738),
MaxCliqueClusteringDetectionAlgorithm.java:23-158 (SPD metric + max-clique
clustering), CountsHelper.updateCountsSV (CountsHelper.java:306-375) and
getPosteriorProbabilities (:410-443).

Host numpy, as in the JAX package: the SPD adjacency matrix of each
partition is one numpy broadcast (the reference loops object pairs);
clique enumeration (graphs/components.py) is sparse, tiny and
data-dependent.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..align.read_alignment import ReadAlignment
from ..core.genome import ReferenceGenome
from ..graphs.components import maximal_cliques, strongly_connected_components
from ..variants.model import (
    CalledGenomicVariant,
    GENOTYPE_HETERO,
    GENOTYPE_HOMOALT,
    GENOTYPE_HOMOREF,
    GENOTYPE_UNDECIDED,
    TYPE_INVERSION,
    TYPE_LARGEDEL,
    TYPE_LARGEINS,
)

# ref: LongReadStructuralVariantDetector.java:32-48
DEF_HET_RATE = 0.5
DEF_PRIOR_HET_RATE = 0.001  # CountsHelper.DEF_HETEROZYGOSITY_RATE_DIPLOID
LOGPROB_ALTCALL_REF = math.log10(0.0001)
LOGPROB_REFCALL_REF = math.log10(0.999)
LOGPROB_REFCALL_ALT = math.log10(0.001)
LOG_ERROR_PROB_SV = math.log10(0.00001)
CLUSTER_STD_NORM_PACBIO = 20
CLUSTER_STD_NORM_ONT = 30
INV_DETERMINING_MAX_DISTANCE = 800
DEL_INTER_DETERMINING_MAX_DISTANCE = 90000
NORM_DIST_BIN_SIZE = 0.01
DEF_LENGTH_SV_EVENT = 50  # ref ":56" lengthToDefineSVEvent
# ref: MaxCliqueClusteringDetectionAlgorithm.java:25-27
PD_NORM_FACTOR = 900.0
EDGE_THRESHOLD = 0.7
MAX_DOWNSTREAM_CONSENSUS = 50
MAX_PARTITION = 300
# ref: CountsHelper.java:45,310 — het-fraction quantization
_NUM_FREQUENCIES = 501
_F_IDX = int(round(DEF_HET_RATE * _NUM_FREQUENCIES))
_LOG_F = math.log10(_F_IDX / (_NUM_FREQUENCIES - 1))
_LOG_1MF = math.log10(1 - _F_IDX / (_NUM_FREQUENCIES - 1))

SIG_INTRA = 0  # ref ":890"
SIG_INTER = 1

# log10 standard-normal pdf at z = 1e-13 + i*0.01, i = 0..1000
# (ref: CountsHelper.java:160-166, JSci NormalDistribution.probability)
_Z = 1e-13 + NORM_DIST_BIN_SIZE * np.arange(1001)
NORM_LOGPDF_CACHE = np.log10(np.exp(-0.5 * _Z * _Z) / math.sqrt(2 * math.pi))


@dataclass
class Signature:
    sequence_name: str
    first: int
    last: int
    length: int
    sv_type: str  # TYPE_LARGEDEL | TYPE_LARGEINS | TYPE_INVERSION
    read_name: str
    aln_key: int  # index into the detector's alignment list
    sig_kind: int = SIG_INTRA
    from_secondary: bool = False


@dataclass
class _Aln:
    """SimplifiedReadAlignment (ref ":756-886")."""
    read_name: str
    sequence_name: str
    first: int
    last: int
    soft_clip_start: int
    soft_clip_end: int
    secondary: bool
    negative_strand: bool
    calls_by_variant: dict[str, Signature] = field(default_factory=dict)


def _log10_sum(a: float, b: float) -> float:
    m = max(a, b)
    return m + math.log10(10 ** (a - m) + 10 ** (b - m))


class LongReadStructuralVariantDetector:
    def __init__(
        self,
        genome: ReferenceGenome,
        min_sv_length: int = DEF_LENGTH_SV_EVENT,
        min_mq: int = 20,
        algorithm: str = "MCC",  # MCC | DBSCAN | SCC (ref ":45-47")
        platform_std_norm: int = CLUSTER_STD_NORM_PACBIO,
    ):
        self.genome = genome
        self.min_sv_length = min_sv_length
        self.min_mq = min_mq
        self.algorithm = algorithm
        self.std_norm = platform_std_norm
        self.alignments: list[_Aln] = []
        self.signatures: list[Signature] = []

    # ---- signature collection ------------------------------------------
    def collect_signatures(self, alns: list[ReadAlignment]) -> None:
        """Intra-alignment indels >= min length + inter-alignment split-read
        signatures (ref: findIntraAlnSignatures:136-152,
        findInterAlnSignatures:154-178)."""
        by_read: dict[str, list[int]] = {}
        for a in alns:
            if a.is_unmapped or a.alignment_quality < self.min_mq:
                continue
            key = len(self.alignments)
            sa = _Aln(
                read_name=a.read_name,
                sequence_name=a.sequence_name,
                first=a.first,
                last=a.last,
                soft_clip_start=a.soft_clip_start,
                soft_clip_end=a.soft_clip_end,
                secondary=a.is_secondary,
                negative_strand=a.is_negative_strand,
            )
            self.alignments.append(sa)
            by_read.setdefault(a.read_name, []).append(key)
            # intra-alignment indels from the CIGAR
            pos = a.first
            for l, op in a.cigar:
                if op == "D":
                    if l >= self.min_sv_length:
                        self._add_signature(
                            sa, key, pos, pos + l - 1, l, TYPE_LARGEDEL, a
                        )
                    pos += l
                elif op == "I":
                    if l >= self.min_sv_length:
                        self._add_signature(
                            sa, key, pos - 1, pos, l, TYPE_LARGEINS, a
                        )
                elif op in "M=X":
                    pos += l
        # inter-alignment signatures per read (split alignments)
        for read_name, keys in by_read.items():
            if len(keys) < 2:
                continue
            regions = [self.alignments[k] for k in keys]
            self._find_inter_aln_signatures(regions, keys)

    def _add_signature(
        self,
        sa: _Aln,
        key: int,
        first: int,
        last: int,
        length: int,
        sv_type: str,
        a: ReadAlignment,
    ) -> None:
        sig = Signature(
            sequence_name=sa.sequence_name,
            first=first,
            last=last,
            length=length,
            sv_type=sv_type,
            read_name=sa.read_name,
            aln_key=key,
            sig_kind=SIG_INTRA,
            from_secondary=a.is_secondary,
        )
        self.signatures.append(sig)

    def _find_inter_aln_signatures(
        self, regions: list[_Aln], keys: list[int]
    ) -> None:
        n = len(regions)
        if n == 2:
            self._inter_aln_indel(regions[0], regions[1], keys[0], keys[1])
        elif n >= 3:
            for i in range(n - 1):
                self._inter_aln_indel(
                    regions[i], regions[i + 1], keys[i], keys[i + 1]
                )
            for i in range(n - 2):
                self._inter_aln_inversion(
                    regions[i], regions[i + 1], regions[i + 2], keys[i + 1]
                )

    def _inter_aln_indel(
        self, a1: _Aln, a2: _Aln, k1: int, k2: int
    ) -> None:
        """Ref: computeInterAlnIndel ":221-262"."""
        distance = abs(a2.first - a1.last)
        first = a1.last + 1
        last = a2.first
        length = last - first + 1
        inter_len = self._estimate_inter_aln_length(a1, a2)
        if (
            distance >= self.min_sv_length
            and inter_len <= 100
            and distance < DEL_INTER_DETERMINING_MAX_DISTANCE
        ):
            if length >= self.min_sv_length:
                sig = Signature(
                    a1.sequence_name, first, last, length, TYPE_LARGEDEL,
                    a1.read_name, k1, SIG_INTER, a1.secondary,
                )
                self.signatures.append(sig)
        elif (
            inter_len >= self.min_sv_length
            and a1.sequence_name == a2.sequence_name
            and a1.negative_strand == a2.negative_strand
        ):
            sig = Signature(
                a1.sequence_name, first, first + 1, inter_len, TYPE_LARGEINS,
                a1.read_name, k1, SIG_INTER, a1.secondary,
            )
            # attach to the alignment spanning it (ref ":338-350")
            if not (a1.first <= first <= a1.last):
                sig.aln_key = k2
                sig.read_name = a2.read_name
            self.signatures.append(sig)

    def _inter_aln_inversion(
        self, a1: _Aln, a2: _Aln, a3: _Aln, k2: int
    ) -> None:
        """Ref: computeInversions ":264-292"."""
        d1 = abs(a2.first - a1.last)
        d2 = abs(a3.first - a2.last)
        if (
            d1 <= INV_DETERMINING_MAX_DISTANCE
            and d2 <= INV_DETERMINING_MAX_DISTANCE
            and a1.negative_strand == a3.negative_strand
            and a1.negative_strand != a2.negative_strand
        ):
            length = a2.last - a2.first + 1
            if length >= self.min_sv_length:
                sig = Signature(
                    a2.sequence_name, a2.first, a2.last, length,
                    TYPE_INVERSION, a2.read_name, k2, SIG_INTER, a2.secondary,
                )
                self.signatures.append(sig)

    @staticmethod
    def _estimate_inter_aln_length(a1: _Aln, a2: _Aln) -> int:
        """Ref: estimateInterAlnLength ":293-305"."""
        if a1.soft_clip_end > a2.soft_clip_start:
            soft_clip = a1.soft_clip_end
            subtract = a2.last - a2.first + 1
        else:
            soft_clip = a2.soft_clip_start
            subtract = a1.last - a1.first + 1
        return soft_clip - subtract

    # ---- clustering -----------------------------------------------------
    @staticmethod
    def spd_matrix(
        firsts: np.ndarray, lasts: np.ndarray, spans: np.ndarray
    ) -> np.ndarray:
        """Span-position distance for all signature pairs in one broadcast
        (ref: calculateSPD ":107-135")."""
        last_adj = np.where(lasts - firsts < 2, firsts + spans - 1, lasts)
        sd = np.abs(spans[:, None] - spans[None, :]) / np.maximum(
            spans[:, None], spans[None, :]
        )
        pd = np.minimum(
            np.abs(firsts[:, None] - firsts[None, :]),
            np.abs(last_adj[:, None] - last_adj[None, :]),
        )
        centered = (firsts - last_adj) // 2
        pd = np.minimum(pd, np.abs(centered[:, None] - centered[None, :]))
        return sd + pd / PD_NORM_FACTOR

    def _cluster_partition(self, part: list[int]) -> list[list[int]]:
        """Cluster one compatible partition of signature indices."""
        sigs = self.signatures
        firsts = np.array([sigs[i].first for i in part], dtype=np.int64)
        lasts = np.array([sigs[i].last for i in part], dtype=np.int64)
        spans = np.array([max(1, sigs[i].length) for i in part], dtype=np.int64)
        spd = self.spd_matrix(firsts, lasts, spans)
        adj = (spd < EDGE_THRESHOLD) & ~np.eye(len(part), dtype=bool)
        if self.algorithm == "SCC":
            adj_list = [list(np.nonzero(adj[i])[0]) for i in range(len(part))]
            comps = strongly_connected_components(adj_list)
        elif self.algorithm == "DBSCAN":
            comps = self._dbscan(adj)
        else:
            comps = maximal_cliques(adj)
        return [[part[i] for i in comp] for comp in comps]

    @staticmethod
    def _dbscan(
        adj: np.ndarray, min_pts: int = 4
    ) -> list[list[int]]:
        """Density clustering on the SPD-threshold graph (ref:
        DBSCANClusteringDetectionAlgorithm.java — epsilon neighbourhood =
        SPD edge, minPts default)."""
        n = adj.shape[0]
        degree = adj.sum(axis=1)
        core = degree >= min_pts
        label = np.full(n, -1)
        cur = 0
        for i in range(n):
            if label[i] != -1 or not core[i]:
                continue
            stack = [i]
            label[i] = cur
            while stack:
                u = stack.pop()
                if not core[u]:
                    continue
                for v in np.nonzero(adj[u])[0]:
                    if label[v] == -1:
                        label[v] = cur
                        stack.append(int(v))
            cur += 1
        return [list(np.nonzero(label == c)[0]) for c in range(cur)]

    def call_variant_clusters(self) -> list[list[int]]:
        """Partition signatures by chromosome+type, break on >50bp gaps or
        size 300, cluster each partition
        (ref: MaxCliqueClusteringDetectionAlgorithm.callVariantClusters
        :38-105)."""
        sigs = self.signatures
        order = sorted(
            range(len(sigs)),
            key=lambda i: (sigs[i].sequence_name, sigs[i].first, sigs[i].last),
        )
        groups: dict[tuple[str, str], list[int]] = {}
        for i in order:
            groups.setdefault((sigs[i].sequence_name, sigs[i].sv_type), []).append(i)
        clusters: list[list[int]] = []
        for (_, _), idxs in groups.items():
            part: list[int] = []
            for j, i in enumerate(idxs):
                part.append(i)
                next_incompat = (
                    j + 1 < len(idxs)
                    and sigs[idxs[j + 1]].first - sigs[i].last
                    >= MAX_DOWNSTREAM_CONSENSUS
                )
                if next_incompat or len(part) >= MAX_PARTITION or j == len(idxs) - 1:
                    if len(part) >= 4:
                        clusters.extend(self._cluster_partition(part))
                    part = []
        return clusters

    # ---- cluster -> variant --------------------------------------------
    def call_variants(
        self, clusters: list[list[int]]
    ) -> list[CalledGenomicVariant]:
        sigs = self.signatures
        variants: list[tuple[CalledGenomicVariant, list[int]]] = []
        counters: dict[str, int] = {}
        for cluster in clusters:
            if not cluster:
                continue
            n_secondary = sum(1 for i in cluster if sigs[i].from_secondary)
            if n_secondary / len(cluster) >= 0.5:
                continue  # ref ":332-336"
            cluster = sorted(cluster, key=lambda i: sigs[i].first)
            firsts = np.array([sigs[i].first for i in cluster])
            ends = np.array([sigs[i].first + sigs[i].length - 1 for i in cluster])
            first = int(firsts.mean())
            end_of_span = int(ends.mean())
            last = end_of_span
            sv_type = sigs[cluster[0]].sv_type
            seq = sigs[cluster[0]].sequence_name
            if sv_type == TYPE_LARGEINS:
                last = first + 1
            length = end_of_span - first + 1
            if length < self.min_sv_length:
                continue
            ref_base = self._ref_base(seq, first)
            num = counters.get(sv_type, 0)
            counters[sv_type] = num + 1
            var = CalledGenomicVariant(
                sequence_name=seq,
                first=first,
                alleles=[ref_base, f"<{sv_type}>"],
                variant_type=sv_type,
                last_=last,
                length_=length,
                var_id=f"NGSEP.{sv_type}.{num}",
            )
            variants.append((var, cluster))
            for i in cluster:
                self.alignments[sigs[i].aln_key].calls_by_variant[var.var_id] = sigs[i]
        variants.sort(key=lambda vc: (vc[0].sequence_name, vc[0].first))
        return self._genotype(variants)

    def _ref_base(self, seq: str, pos: int) -> str:
        try:
            return self.genome.reference_string(seq, pos, pos)
        except Exception:
            return "N"

    # ---- genotyping -----------------------------------------------------
    def _genotype(
        self, variants: list[tuple[CalledGenomicVariant, list[int]]]
    ) -> list[CalledGenomicVariant]:
        """Bayesian genotyping against spanning alignments
        (ref: makeBayesianGenotypeCalls ":448-480",
        assignBayesianGenotype ":526-538", updateCountsSV semantics)."""
        # sort alignments per sequence for interval queries
        by_seq: dict[str, list[_Aln]] = {}
        for a in self.alignments:
            by_seq.setdefault(a.sequence_name, []).append(a)
        for seq in by_seq:
            by_seq[seq].sort(key=lambda a: (a.first, a.last))
        out: list[CalledGenomicVariant] = []
        for var, cluster in variants:
            alns = by_seq.get(var.sequence_name, [])
            spanning = [
                a for a in alns if a.first <= var.last and a.last >= var.first
            ]
            if not spanning:
                continue  # UNDECIDED (ref ":460-461")
            calls = self._spanning_calls(var, spanning)
            gt, qual = self._decide_genotype(var, calls)
            if gt in (GENOTYPE_UNDECIDED, GENOTYPE_HOMOREF):
                continue
            var.quality = qual
            var.genotype_quality = qual
            var.indexes_called_alleles = [0, 1] if gt == GENOTYPE_HETERO else [1]
            var.total_read_depth = len(calls)
            out.append(var)
        return self._filter_intersecting(out)

    def _spanning_calls(
        self, var: CalledGenomicVariant, spanning: list[_Aln]
    ) -> list[tuple[str, int]]:
        """Returns (allele, length) call list: ALT with the signature length
        or REF with 0 (ref: computeSpanningAlnCall ":539-561")."""
        calls: list[tuple[str, int]] = []
        visited_inter: set[str] = set()
        for a in spanning:
            sig = a.calls_by_variant.get(var.var_id)
            if sig is not None:
                if sig.sig_kind == SIG_INTER:
                    if sig.read_name in visited_inter:
                        continue
                    visited_inter.add(sig.read_name)
                calls.append(("ALT", sig.length))
            else:
                if not self._covers(a, var):
                    continue
                calls.append(("REF", 0))
        return calls

    @staticmethod
    def _covers(a: _Aln, var: CalledGenomicVariant) -> bool:
        """Ref: alignmentCoversVariant ":562-579"."""
        if var.variant_type == TYPE_LARGEINS:
            tol = 200
            if abs(a.first - var.first) < tol or abs(a.last - var.last) < tol:
                return False
        elif var.variant_type == TYPE_LARGEDEL:
            tol = 1000
            if (a.last - var.first) < tol or (var.last - a.first) < tol:
                return False
        return True

    def _decide_genotype(
        self, var: CalledGenomicVariant, calls: list[tuple[str, int]]
    ) -> tuple[int, int]:
        """2-allele posterior from z-scored length likelihoods
        (ref: calculateCountsSV ":588-606", CountsHelper.updateCountsSV,
        decideGenotype ":608-637")."""
        avg_len = var.length()
        std = avg_len / self.std_norm
        lcp = np.zeros((2, 2))  # log conditional probs [i][j]
        for allele, call_len in calls:
            if allele == "ALT":
                z = 0.0 if std == 0 else (call_len - avg_len) / std
                nd_idx = min(1000, abs(int(z / NORM_DIST_BIN_SIZE)))
                cond = [
                    max(LOG_ERROR_PROB_SV, LOGPROB_ALTCALL_REF),
                    max(LOG_ERROR_PROB_SV, NORM_LOGPDF_CACHE[nd_idx]),
                ]
                index = 1
            else:
                cond = [
                    max(LOG_ERROR_PROB_SV, LOGPROB_REFCALL_REF),
                    max(LOG_ERROR_PROB_SV, LOGPROB_REFCALL_ALT),
                ]
                index = 0
            best = -1
            for i in (0, 1):
                if cond[i] > LOG_ERROR_PROB_SV and (best < 0 or cond[best] < cond[i]):
                    best = i
            if best >= 0 and best != index:
                index = min(index, best)
            lcp[0][0] += cond[0]
            lcp[1][1] += cond[1]
            for i in (0, 1):
                j = 1 - i
                if j == index:
                    lcp[i][j] += _log10_sum(
                        _LOG_F + cond[index], _LOG_1MF + LOG_ERROR_PROB_SV
                    )
                else:  # i == index
                    lcp[i][j] += _log10_sum(
                        _LOG_1MF + cond[index], _LOG_F + LOG_ERROR_PROB_SV
                    )
        log_prior_het = math.log10(DEF_PRIOR_HET_RATE / 2)
        log_prior_hom = math.log10((1 - DEF_PRIOR_HET_RATE) / 2)
        events = np.array(
            [
                lcp[0][0] + log_prior_hom,
                lcp[0][1] + log_prior_het,
                lcp[1][0] + log_prior_het,
                lcp[1][1] + log_prior_hom,
            ]
        )
        probs = 10.0 ** (events - events.max())
        probs /= probs.sum()
        best_idx = int(np.argmax(probs))
        if best_idx in (1, 2):
            gt = GENOTYPE_HETERO
            q = probs[1] + probs[2]
        elif best_idx == 3:
            gt = GENOTYPE_HOMOALT
            q = probs[3]
        else:
            gt = GENOTYPE_HOMOREF
            q = probs[0]
        one_minus = max(1 - q, 5e-324)
        phred = int(-10 * math.log10(one_minus))
        return gt, min(255, phred)

    @staticmethod
    def _filter_intersecting(
        variants: list[CalledGenomicVariant],
    ) -> list[CalledGenomicVariant]:
        """Keep the highest-quality variant among mutually spanning ones
        (ref: filterIntersectingVariants ":646-669")."""
        out: list[CalledGenomicVariant] = []
        n = len(variants)
        visited = [False] * n
        for i in range(n):
            if visited[i]:
                continue
            v = variants[i]
            group = [
                j
                for j in range(n)
                if variants[j].sequence_name == v.sequence_name
                and variants[j].first <= v.last
                and variants[j].last >= v.first
            ]
            if len(group) < 2:
                out.append(v)
                continue
            best = max(group, key=lambda j: variants[j].genotype_quality)
            out.append(variants[best])
            for j in group:
                visited[j] = True
        return out

    # ---- entry point ----------------------------------------------------
    def find_variants(
        self, alns: list[ReadAlignment]
    ) -> list[CalledGenomicVariant]:
        self.collect_signatures(alns)
        clusters = self.call_variant_clusters()
        return self.call_variants(clusters)
