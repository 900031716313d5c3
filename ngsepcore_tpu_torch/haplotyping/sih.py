"""Single individual haplotyping (SIH).

Ref: src/ngsep/haplotyping/ — SingleIndividualHaplotyper.java (command
`SIH`: input = single-sample VCF + alignments; fragment matrix ->
SIHAlgorithm -> phased blocks), SIHAlgorithm.java:12-20 (pluggable
algorithms), RefhapSIHAlgorithm.java + FragmentsCutBuilder.java (max-cut
on the fragment conflict graph), HaplotypeBlock.java / HaplotypeFragment
(fragment matrix model).

The fragment matrix is a dense (fragments, variants) int8 matrix (-1 =
not covered); the RefHap max-cut refinement is iterated matrix-vector
work — agreement scores for all fragments against the current haplotype
in one masked reduction per sweep.  A numpy copy of
ngsepcore_tpu/haplotyping/sih.py (it runs on the host there too).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..align.read_alignment import ReadAlignment
from ..variants.model import CalledGenomicVariant
from ..vcf.io import VCFRecord


@dataclass
class HaplotypeFragment:
    read_name: str
    first_var: int  # index of first covered variant
    calls: np.ndarray  # int8 alleles (0/1, -1 missing) from first_var


@dataclass
class HaplotypeBlock:
    var_indices: list[int]
    haplotype: np.ndarray  # int8 0/1 per variant (allele of haplotype 0)
    mec: int = 0  # minimum error correction score


def build_fragment_matrix(
    alignments: list[ReadAlignment], het_calls: list[CalledGenomicVariant]
) -> np.ndarray:
    """(fragments, variants) matrix of 0/1 alleles, -1 uncovered.

    Only biallelic het SNVs are phaseable (ref: SIH input filtering).
    """
    positions = {(c.sequence_name, c.first): i for i, c in enumerate(het_calls)}
    alleles = [(c.alleles[0], c.alleles[1]) for c in het_calls]
    rows = []
    for a in alignments:
        if a.is_unmapped or not a.read_chars:
            continue
        row = np.full(len(het_calls), -1, np.int8)
        covered = 0
        for (seq, pos), vi in positions.items():
            if seq != a.sequence_name or pos < a.first or pos > a.last:
                continue
            rp = a.read_position_at(pos)
            if rp < 0 or rp >= len(a.read_chars):
                continue
            base = a.read_chars[rp].upper()
            if base == alleles[vi][0]:
                row[vi] = 0
                covered += 1
            elif base == alleles[vi][1]:
                row[vi] = 1
                covered += 1
        if covered >= 2:  # fragments spanning <2 hets carry no phase info
            rows.append(row)
    if not rows:
        return np.empty((0, len(het_calls)), np.int8)
    return np.stack(rows)


class FragmentsCutBuilder:
    """Max-cut over the fragment conflict graph — the actual RefHap
    construction (ref: FragmentsCutBuilder.java).

    Edge weight between overlapping fragments = hamming2 = (#disagreeing
    covered columns) - (#agreeing ones); conflicting pairs get positive
    weights, consistent pairs negative.  `calculate_max_cut` runs up to
    sqrt(E)+1 restarts, each seeded from one positive edge: a greedy
    whole-graph assignment by maximum |cross-weight difference| (initCut
    :140-167), then alternating single-vertex flips (heuristic1:216-234)
    and paired-edge flips (heuristic2:236-269) until no cut-score gain;
    the best-scoring cut wins, with the reference's every-10-iterations
    early stop (calculateMaxCut:75-111).

    Vectorized: weights live in one (F, F) matrix; flip gains for every
    vertex are c * (W @ c) maintained incrementally (O(F) per flip)."""

    def __init__(self, fragments: np.ndarray):
        self.frag = fragments
        covered = fragments >= 0
        m0 = ((fragments == 0) & covered).astype(np.int32)
        m1 = ((fragments == 1) & covered).astype(np.int32)
        agree = m0 @ m0.T + m1 @ m1.T
        disagree = m0 @ m1.T + m1 @ m0.T
        W = (disagree - agree).astype(np.float64)
        np.fill_diagonal(W, 0.0)
        # no-overlap pairs carry zero weight already (both terms zero)
        self.W = W
        ii, jj = np.nonzero(np.triu(W, 1))
        w = W[ii, jj]
        order = np.argsort(-w, kind="stable")  # weight desc (ref sort)
        self.edges = (ii[order], jj[order], w[order])

    def _init_cut(self, e1: int, e2: int) -> np.ndarray:
        """Greedy full assignment from a seed edge (ref initCut)."""
        F = self.W.shape[0]
        c = np.zeros(F, np.float64)  # +1 cut group, -1 other, 0 unassigned
        c[e1] = -1.0  # cut[e1]=False
        c[e2] = 1.0  # cut[e2]=True
        # diff_v = sum_{assigned cut} w - sum_{assigned !cut} w = W @ c
        d = self.W[:, e1] * c[e1] + self.W[:, e2] * c[e2]
        unassigned = np.ones(F, bool)
        unassigned[[e1, e2]] = False
        for _ in range(F - 2):
            cand = np.where(unassigned, np.abs(d), -1.0)
            v = int(np.argmax(cand))
            group = d[v] < 0  # join cut side when diff negative (ref)
            c[v] = 1.0 if group else -1.0
            d += self.W[:, v] * c[v]
            unassigned[v] = False
        return c

    def _improve(self, c: np.ndarray) -> np.ndarray:
        """heuristic1 + heuristic2 alternation until no improvement."""
        W = self.W
        ei, ej, ew = self.edges
        wc = W @ c
        improvement = True
        while improvement:
            # heuristic1: flip the single vertex with max positive gain
            while True:
                gains = c * wc
                v = int(np.argmax(gains))
                if gains[v] <= 0:
                    break
                wc -= 2.0 * c[v] * W[:, v]
                c[v] = -c[v]
            improvement = False
            # heuristic2: flip the edge pair with max positive joint gain
            while len(ew):
                g = (
                    c[ei] * wc[ei]
                    + c[ej] * wc[ej]
                    - 2.0 * ew * c[ei] * c[ej]
                )
                k = int(np.argmax(g))
                if g[k] <= 0:
                    break
                for v in (int(ei[k]), int(ej[k])):
                    wc -= 2.0 * c[v] * W[:, v]
                    c[v] = -c[v]
                improvement = True
        return c

    def _cut_score(self, c: np.ndarray) -> float:
        ei, ej, ew = self.edges
        return float(np.sum(ew[c[ei] != c[ej]]))

    def calculate_max_cut(self) -> np.ndarray:
        """Returns the cut as a bool array (True = complement group)."""
        F = self.W.shape[0]
        ei, ej, ew = self.edges
        pos = np.nonzero(ew > 0)[0]
        if F == 0 or len(pos) == 0:
            return np.zeros(F, bool)
        iters = int(np.sqrt(len(ew))) + 1
        best_c = None
        best_score = 0.0
        score_change = False
        n_done = 0
        for k in pos[:iters]:
            c = self._improve(self._init_cut(int(ei[k]), int(ej[k])))
            s = self._cut_score(c)
            if s > best_score:
                best_score = s
                best_c = c.copy()
                score_change = True
            n_done += 1
            if n_done % 10 == 0:
                if not score_change:
                    break  # ref: no score change in 10 iterations
                score_change = False
        if best_c is None:
            best_c = self._improve(self._init_cut(int(ei[pos[0]]), int(ej[pos[0]])))
        return best_c > 0


class RefhapSIHAlgorithm:
    """RefHap: max-cut on the fragment conflict graph, then consensus.

    Ref: RefhapSIHAlgorithm.java:20-40 — build the cut with
    FragmentsCutBuilder.calculateMaxCut and translate it to a haplotype
    with the combined consensus (CutHaplotypeTranslator)."""

    def __init__(self, max_iter: int = 50, seed: int = 1):
        self.max_iter = max_iter  # kept for API compat; unused
        self.rng = np.random.default_rng(seed)

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        """Returns (haplotype (V,) int8, MEC score)."""
        F, V = fragments.shape
        if F == 0:
            return np.zeros(V, np.int8), 0
        cut = FragmentsCutBuilder(fragments).calculate_max_cut()
        hap = _consensus_from_cut(fragments, cut)
        return hap, _mec(fragments, hap, cut)


def _consensus_from_cut(fragments: np.ndarray, cut: np.ndarray) -> np.ndarray:
    """Haplotype consensus from a fragment 2-coloring (CutHaplotypeTranslator
    .getHaplotype CONSENSUS_COMBINED, CutHaplotypeTranslator.java:33-60)."""
    covered = fragments >= 0
    v1 = ((fragments == 1) & covered & ~cut[:, None]).sum(axis=0) + (
        (fragments == 0) & covered & cut[:, None]
    ).sum(axis=0)
    v0 = ((fragments == 0) & covered & ~cut[:, None]).sum(axis=0) + (
        (fragments == 1) & covered & cut[:, None]
    ).sum(axis=0)
    return (v1 > v0).astype(np.int8)


def _mec(fragments: np.ndarray, hap: np.ndarray, cut: np.ndarray) -> int:
    covered = fragments >= 0
    frag_hap = np.where(cut[:, None], 1 - hap[None, :], hap[None, :])
    return int(((fragments != frag_hap) & covered).sum())


def _hamming2(fragments: np.ndarray, hap: np.ndarray) -> np.ndarray:
    """Per-fragment (disagreements - agreements) against hap, counting only
    decided hap positions (HaplotypeBlock.getHamming2)."""
    decided = (hap >= 0)[None, :] & (fragments >= 0)
    dis = ((fragments != hap[None, :]) & decided).sum(axis=1)
    agr = ((fragments == hap[None, :]) & decided).sum(axis=1)
    return dis - agr


class DGSSIHAlgorithm:
    """DGS greedy growth + consensus iteration.

    Ref: DGSSIHAlgorithm.java:39-127 — seed with the fragment carrying the
    most calls, repeatedly attach the unassigned fragment with the largest
    |hamming2| score to the matching side (initCut :54-97), then alternate
    consensus haplotype / cut reassignment until the haplotype is stable
    (buildHaplotype :39-52, <=1000 iterations).
    """

    def __init__(self, max_iter: int = 1000):
        self.max_iter = max_iter

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        F, V = fragments.shape
        if F == 0:
            return np.zeros(V, np.int8), 0
        covered = fragments >= 0
        hap = np.full(V, -1, np.int8)
        assigned = np.zeros(F, bool)
        cut = np.zeros(F, bool)
        seed = int(np.argmax(covered.sum(axis=1)))
        assigned[seed] = True
        upd = (hap < 0) & covered[seed]
        hap[upd] = fragments[seed][upd]
        for _ in range(F - 1):
            scores = _hamming2(fragments, hap)
            scores[assigned] = 0
            i = int(np.argmax(np.abs(scores)))
            if scores[i] == 0 and assigned[i]:
                break
            assigned[i] = True
            cut[i] = scores[i] > 0
            row = fragments[i] if not cut[i] else np.where(
                fragments[i] >= 0, 1 - fragments[i], -1
            )
            upd = (hap < 0) & (row >= 0)
            hap[upd] = row[upd]
        hap = np.where(hap < 0, 0, hap).astype(np.int8)
        for _ in range(self.max_iter):
            new_hap = _consensus_from_cut(fragments, cut)
            if np.array_equal(new_hap, hap):
                break
            hap = new_hap
            cut = _hamming2(fragments, hap) > 0
        return hap, _mec(fragments, hap, cut)


class Refhap2SIHAlgorithm(RefhapSIHAlgorithm):
    """Max-cut with the builder's alternative strategy 2 — here random
    multi-restart local search keeping the best-MEC solution
    (ref: Refhap2SIHAlgorithm.java calls calculateMaxCutStrategy2)."""

    def __init__(self, restarts: int = 5, seed: int = 2):
        super().__init__()
        self.restarts = restarts
        self.rng = np.random.default_rng(seed)

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        best = super().phase(fragments)
        F, V = fragments.shape
        if F == 0:
            return best
        covered = fragments >= 0
        for _ in range(self.restarts):
            cut = self.rng.random(F) < 0.5
            hap = _consensus_from_cut(fragments, cut)
            for _ in range(self.max_iter):
                new_cut = _hamming2(fragments, hap) > 0
                new_hap = _consensus_from_cut(fragments, new_cut)
                if np.array_equal(new_hap, hap):
                    break
                hap, cut = new_hap, new_cut
            mec = _mec(fragments, hap, _hamming2(fragments, hap) > 0)
            if mec < best[1]:
                best = (hap, mec)
        return best


class Refhap3SIHAlgorithm(Refhap2SIHAlgorithm):
    """Max-cut strategy 3 (ref: Refhap3SIHAlgorithm.java) — deeper restart
    schedule."""

    def __init__(self):
        super().__init__(restarts=10, seed=3)


class GroupsSIHAlgorithm:
    """Group-seeded phasing: seed the first haplotype group with the
    fragment having the most low-disagreement overlaps, then assign the
    rest by agreement (ref: GroupsSIHAlgorithm.java:44-140)."""

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        F, V = fragments.shape
        if F == 0:
            return np.zeros(V, np.int8), 0
        covered = fragments >= 0
        # pairwise disagreement counts on shared sites (small blocks: dense)
        eq = (fragments[:, None, :] == fragments[None, :, :]) & (
            covered[:, None, :] & covered[None, :, :]
        )
        shared = (covered[:, None, :] & covered[None, :, :]).sum(axis=2)
        agree = eq.sum(axis=2)
        dis = shared - agree
        friendly = ((dis <= agree) & (shared > 0)).sum(axis=1)
        seed = int(np.argmax(friendly))
        cut = np.zeros(F, bool)
        cut = (dis[seed] > agree[seed]) & (shared[seed] > 0)
        hap = _consensus_from_cut(fragments, cut)
        cut = _hamming2(fragments, hap) > 0
        hap = _consensus_from_cut(fragments, cut)
        return hap, _mec(fragments, hap, cut)


class HapChatSIHAlgorithm:
    """Iterative k-bounded error correction then consensus, in the HapChat
    style (ref: HapChatSIHAlgorithm.java — merge fragments whose corrected
    distance fits within k errors, then phase the merged matrix)."""

    def __init__(self, k: int = 2):
        self.k = k

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        base = RefhapSIHAlgorithm()
        hap, mec = base.phase(fragments)
        covered = fragments >= 0
        # correct up to k errors per fragment toward its assigned side and
        # re-phase once (HapChat's bounded-correction step)
        side = _hamming2(fragments, hap) > 0
        target = np.where(side[:, None], 1 - hap[None, :], hap[None, :])
        errs = (fragments != target) & covered
        fixed = fragments.copy()
        for i in range(len(fragments)):
            bad = np.nonzero(errs[i])[0][: self.k]
            fixed[i, bad] = target[i, bad]
        return base.phase(fixed)[0], mec


class GenHapSIHAlgorithm:
    """GenHap genetic algorithm over fragment 2-colorings.

    Ref: GenHapSIHAlgorithm.java:54-175 — population of 100 cuts seeded by
    the haplotype-agreement init, evolved for up to 100 generations with
    an early stop after 25 generations without a best-fitness change;
    each generation keeps ~90%% of the individuals (the best always
    survives) and fills the remainder with mutation/crossover offspring
    (recalculateCuts:134-173, mutateOrCross:175-190); fitness is the
    agreement of the cut's consensus haplotypes with the fragments
    (calculateFitness:298-323 — equivalently -MEC here)."""

    def __init__(self, population: int = 100, generations: int = 100,
                 stable_stop: int = 25, seed: int = 7):
        self.population = population
        self.generations = generations
        self.stable_stop = stable_stop
        self.rng = np.random.default_rng(seed)

    def _fitness(self, fragments, cut):
        hap = _consensus_from_cut(fragments, cut)
        return -_mec(fragments, hap, cut), hap

    @staticmethod
    def _refine(fragments, cut, sweeps: int = 10):
        """Reassignment sweeps to a fixpoint: each fragment joins the side
        whose consensus it agrees with best (ref calculateCuts reassigns
        cut bits from fragment/haplotype agreement per generation
        :105-118)."""
        for _ in range(sweeps):
            hap = _consensus_from_cut(fragments, cut)
            new_cut = _hamming2(fragments, hap) > 0
            if np.array_equal(new_cut, cut):
                break
            cut = new_cut
        return cut

    def phase(self, fragments: np.ndarray) -> tuple[np.ndarray, int]:
        F, V = fragments.shape
        if F == 0:
            return np.zeros(V, np.int8), 0
        # population seeded around the agreement init (ref initCut seeds
        # from per-fragment haplotype agreement) plus random refined
        # starts for diversity
        base = _hamming2(fragments, _consensus_from_cut(
            fragments, np.zeros(F, bool))) > 0
        pop = [self._refine(fragments, base.copy())]
        while len(pop) < self.population:
            start = self.rng.random(F) < 0.5
            pop.append(self._refine(fragments, start))
        scored = [self._fitness(fragments, c) + (c,) for c in pop]
        best_fit = max(s[0] for s in scored)
        stable = 0
        for _gen in range(self.generations):
            if stable >= self.stable_stop:
                break  # ref countStop==25 early exit
            scored.sort(key=lambda t: -t[0])
            # ~90% survive; the best always does (ref recalculateCuts)
            n_keep = max(2, int(round(0.9 * self.population)))
            survivors = scored[:n_keep]
            children = []
            while len(survivors) + len(children) < self.population:
                if self.rng.random() < 0.5:  # mutate (ref mutateOrCross)
                    src = survivors[int(self.rng.integers(len(survivors)))][2]
                    mut = self.rng.random(F) < max(1.0 / F, 0.05)
                    child = src ^ mut
                else:  # single-point crossover of two random survivors
                    a = survivors[int(self.rng.integers(len(survivors)))][2]
                    b = survivors[int(self.rng.integers(len(survivors)))][2]
                    point = int(self.rng.integers(1, F)) if F > 1 else 0
                    child = a.copy()
                    child[point:] = b[point:]
                # memetic step: children are locally refined before they
                # compete (the reference reassigns every individual's bits
                # against the two consensus haplotypes each generation)
                children.append(self._refine(fragments, child))
            scored = survivors + [
                self._fitness(fragments, c) + (c,) for c in children
            ]
            new_best = max(s[0] for s in scored)
            if new_best > best_fit:
                best_fit = new_best
                stable = 0
            else:
                stable += 1
        fit, hap, cut = max(scored, key=lambda t: t[0])
        return hap, _mec(fragments, hap, cut)


SIH_ALGORITHMS = {
    "Refhap": RefhapSIHAlgorithm,
    "Refhap2": Refhap2SIHAlgorithm,
    "Refhap3": Refhap3SIHAlgorithm,
    "DGS": DGSSIHAlgorithm,
    "Groups": GroupsSIHAlgorithm,
    "HapChat": HapChatSIHAlgorithm,
    "GenHap": GenHapSIHAlgorithm,
}


class SingleIndividualHaplotyper:
    def __init__(self, algorithm: str = "Refhap"):
        self.algorithm_name = algorithm
        by_lower = {k.lower(): v for k, v in SIH_ALGORITHMS.items()}
        cls = by_lower.get(algorithm.lower())
        if cls is None:
            raise ValueError(
                f"Unknown SIH algorithm {algorithm!r}; options: "
                + ", ".join(SIH_ALGORITHMS)
            )
        self._algo = cls()

    def phase(
        self,
        records: list[VCFRecord],
        alignments: list[ReadAlignment],
    ) -> list[HaplotypeBlock]:
        """Phase het biallelic SNVs into blocks connected by fragments."""
        het_calls = [
            r.calls[0]
            for r in records
            if r.calls
            and r.calls[0].is_heterozygous
            and r.variant.is_snv
            and r.variant.is_biallelic
        ]
        if not het_calls:
            return []
        frags = build_fragment_matrix(alignments, het_calls)
        if len(frags) == 0:
            return []
        # connected components of variants linked by shared fragments
        V = frags.shape[1]
        parent = list(range(V))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        for row in frags:
            cov = np.nonzero(row >= 0)[0]
            for i in range(1, len(cov)):
                union(int(cov[0]), int(cov[i]))
        comps: dict[int, list[int]] = {}
        for v in range(V):
            comps.setdefault(find(v), []).append(v)
        blocks = []
        for comp in comps.values():
            if len(comp) < 2:
                continue
            sub = frags[:, comp]
            keep = (sub >= 0).sum(axis=1) >= 2
            sub = sub[keep]
            if len(sub) == 0:
                continue
            hap, mec = self._algo.phase(sub)
            blocks.append(HaplotypeBlock(var_indices=comp, haplotype=hap, mec=mec))
            # annotate calls as phased
            for local, vi in enumerate(comp):
                c = het_calls[vi]
                c.phased = True
                a = int(hap[local])
                c.indexes_called_alleles = [a, 1 - a]
        return blocks
