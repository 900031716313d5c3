"""The benchmark's inputs, made from numbers alone (numpy only).

Frozen copies of the repository's generators, so that no later change to
the program can change what the benchmark feeds it:

- `build_repeat_genome`: chip_smoke.build_repeat_genome (bench.py's
  genome): random codes, dispersed repeat families at 92-99% identity and
  short tandem arrays;
- `simulate_individual`, `haplotypes`: the port's
  simulation/individual_simulator.py (SingleIndividualSimulator.simulate,
  build_haplotype_genomes) on one sequence;
- `simulate_reads`: the port's simulation/reads_simulator.py
  (`simulate_block`) on one haplotype sequence.

Each draws from numpy's generator in exactly the order of its original, so
the same seeds give the same codes, variants and reads byte for byte
(perfbench/tests/test_perfbench_inputs.py holds them to it).  Besides the
reads, `simulate_reads` returns each read's origin (haplotype start and
strand), which the reference's truth pileup reads.

`make_reference` lays a configuration's sequences (a published assembly's
names and lengths) over one repeat genome of their total length, so
dispersed families recur across sequences; `make_sample` simulates a
diploid individual of every sequence and draws its reads from all of them
at the configuration's coverage, in a shuffled order as a FASTQ has them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_CODE = 4
BASES = "ACGT"
LANE = 16  # reads are padded to a multiple of 16 columns with N


def build_repeat_genome(rng, L: int, n_families: int, n_tandem: int):
    """Codes of length L, the merged repeat intervals (0-based half-open),
    the tandem arrays in planting order and the families as (source start,
    length, source segment, copy starts)."""
    codes = rng.integers(0, 4, size=L).astype(np.int8)
    intervals = []
    tandem = []
    families = []
    for _fam in range(n_families):
        slen = int(rng.integers(500, 4000))
        src = int(rng.integers(0, L - slen))
        seg = codes[src : src + slen].copy()
        intervals.append((src, src + slen))
        families.append((src, slen, seg, []))
        for _copy in range(int(rng.integers(4, 16))):
            dst = int(rng.integers(0, L - slen))
            families[-1][3].append(dst)
            cp = seg.copy()
            div = float(rng.uniform(0.01, 0.08))
            nmut = int(rng.binomial(slen, div))
            if nmut:
                mpos = rng.choice(slen, size=nmut, replace=False)
                cp[mpos] = (cp[mpos] + rng.integers(1, 4, size=nmut)) % 4
            codes[dst : dst + slen] = cp
            intervals.append((dst, dst + slen))
    for _t in range(n_tandem):
        mlen = int(rng.integers(2, 7))
        ncopies = int(rng.integers(8, 41))
        span = mlen * ncopies
        dst = int(rng.integers(0, L - span))
        codes[dst : dst + span] = np.tile(
            rng.integers(0, 4, size=mlen).astype(np.int8), ncopies
        )
        intervals.append((dst, dst + span))
        tandem.append((dst, dst + span))
    intervals.sort()
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return codes, np.asarray(merged, dtype=np.int64), tandem, families


def repeat_genome(length: int, seed: int, families_per_12mbp: int, tandem_per_12mbp: int):
    """bench.py's genome of `length` bases: the family and tandem-array
    counts scaled by length / 12 Mbp (chip_smoke.real_size_inputs).
    Returns (codes, merged repeat intervals, tandem arrays)."""
    rng = np.random.default_rng(seed)
    scale = length / 12e6
    codes, repeat_iv, tandem, _ = build_repeat_genome(
        rng, int(length), round(families_per_12mbp * scale), round(tandem_per_12mbp * scale),
    )
    return codes, repeat_iv, tandem


@dataclass(frozen=True)
class Variant:
    """One planted variant: 1-based `first`, alleles as strings, and the
    haplotypes that carry the alternative (het: the second only)."""

    first: int
    ref: str
    alt: str
    het: bool

    @property
    def is_snv(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1


def _decode(codes) -> str:
    return "".join(BASES[int(c)] if c < 4 else "N" for c in codes)


def simulate_individual(seq: np.ndarray, snv_rate: float, indel_rate: float,
                        seed: int, het_fraction: float = 0.5) -> list[Variant]:
    """A diploid individual of one sequence: SNVs at snv_rate, 1-3 bp
    indels at indel_rate away from the SNVs, each heterozygous with
    probability het_fraction.  Sorted by position."""
    rng = np.random.default_rng(seed)
    calls: list[Variant] = []
    L = len(seq)
    n_snv = rng.poisson(snv_rate * L)
    n_ind = rng.poisson(indel_rate * L)
    pos_snv = rng.choice(L, size=min(n_snv, L), replace=False)
    used = set(int(p) for p in pos_snv)
    for p in sorted(int(x) for x in pos_snv):
        ref_code = int(seq[p])
        if ref_code >= 4:
            continue
        alt_code = (ref_code + int(rng.integers(1, 4))) % 4
        het = rng.random() < het_fraction
        calls.append(Variant(p + 1, BASES[ref_code], BASES[alt_code], bool(het)))
    tries = 0
    planted = 0
    while planted < n_ind and tries < 10 * n_ind + 10:
        tries += 1
        p = int(rng.integers(10, max(11, L - 10)))
        if any((p + d) in used for d in range(-4, 5)):
            continue
        if np.any(seq[p : p + 4] >= 4):
            continue
        ilen = int(rng.integers(1, 4))
        if rng.random() < 0.5:  # deletion of ilen bases after the anchor
            ref = _decode(seq[p : p + 1 + ilen])
            alt = ref[0]
        else:  # insertion after the anchor
            ins = "".join(rng.choice(list("ACGT"), size=ilen))
            ref = _decode(seq[p : p + 1])
            alt = ref + ins
        het = rng.random() < het_fraction
        for d in range(-4, len(ref) + 4):
            used.add(p + d)
        calls.append(Variant(p + 1, ref, alt, bool(het)))
    calls.sort(key=lambda c: c.first)
    return calls


def haplotypes(seq: np.ndarray, calls: list[Variant]):
    """The two haplotype sequences and, for each, the 0-based reference
    position of every haplotype base (-1 for an inserted base)."""
    out = []
    enc = np.full(128, N_CODE, np.int8)
    for i, b in enumerate(BASES):
        enc[ord(b)] = i
    for h in range(2):
        pieces, maps = [], []
        cursor = 0
        for c in calls:
            if h == 0 and c.het:
                continue
            p0 = c.first - 1
            if p0 < cursor:
                continue
            pieces.append(seq[cursor:p0])
            maps.append(np.arange(cursor, p0, dtype=np.int64))
            alt = enc[np.frombuffer(c.alt.encode(), np.uint8)]
            pieces.append(alt)
            # the alt's bases shared with the ref (the anchor, and an SNV's
            # one base) sit on the ref's positions; inserted bases on none
            shared = min(len(c.ref), len(c.alt))
            m = np.full(len(alt), -1, np.int64)
            m[:shared] = p0 + np.arange(shared)
            maps.append(m)
            cursor = p0 + len(c.ref)
        pieces.append(seq[cursor:])
        maps.append(np.arange(cursor, len(seq), dtype=np.int64))
        out.append((np.concatenate(pieces), np.concatenate(maps)))
    return out


def simulate_reads(hap: np.ndarray, n: int, read_len: int, error_rate: float,
                   seed: int, seq_name: str):
    """n reads of read_len from one haplotype sequence: uniform starts,
    substitutions at error_rate, half reverse-complemented, codes padded
    with N to a multiple of 16 columns.  Returns (codes, start (0-based on
    the haplotype), reverse, names)."""
    rng = np.random.default_rng(seed)
    L = read_len
    seq_lengths = np.array([len(hap)], dtype=np.float64)
    probs = np.where(seq_lengths >= L, seq_lengths, 0.0)
    probs = probs / probs.sum()
    si = rng.choice(1, size=n, p=probs)
    start = (rng.random(n) * (seq_lengths[si] - L + 1)).astype(np.int64)
    codes = hap[start[:, None] + np.arange(L, dtype=np.int64)[None, :]]
    codes = codes.astype(np.int8, copy=True)
    if error_rate > 0:
        errs = rng.random((n, L)) < error_rate
        shift = rng.integers(1, 4, size=(n, L)).astype(np.int8)
        codes = np.where(errs & (codes < 4), (codes + shift) % 4, codes).astype(np.int8)
        del errs, shift
    reverse = rng.random(n) < 0.5
    flipped = codes[:, ::-1]
    flipped = np.where(flipped < 4, 3 - flipped, flipped).astype(np.int8)
    codes = np.where(reverse[:, None], flipped, codes)
    Lp = -(-L // LANE) * LANE
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)), constant_values=N_CODE)
    names = [
        f"{seq_name}_{int(p) + 1}_{bool(r)}_{i + 1}"
        for i, (p, r) in enumerate(zip(start, reverse))
    ]
    return codes, start, reverse, names


@dataclass
class Reference:
    """A configuration's reference: named sequences and, for each, its
    merged repeat intervals (0-based half-open, on that sequence)."""

    names: list[str]
    seqs: list[np.ndarray]
    repeat_iv: list[np.ndarray]


def make_reference(ref_cfg: dict) -> Reference:
    """The sequences of `ref_cfg["sequences"]` ([name, length] pairs), cut
    in order from one repeat genome of their total length."""
    lengths = [int(n) for _, n in ref_cfg["sequences"]]
    codes, repeat_iv, _ = repeat_genome(
        sum(lengths), ref_cfg["genome_seed"], ref_cfg["repeat_families_per_12mbp"],
        ref_cfg["tandem_arrays_per_12mbp"],
    )
    ends = np.cumsum(lengths)
    seqs, ivs = [], []
    for lo, hi in zip(ends - lengths, ends):
        seqs.append(codes[lo:hi].copy())
        iv = repeat_iv[(repeat_iv[:, 1] > lo) & (repeat_iv[:, 0] < hi)]
        ivs.append(np.clip(iv, lo, hi) - lo)
    return Reference([name for name, _ in ref_cfg["sequences"]], seqs, ivs)


@dataclass
class Sample:
    """One simulated sample: for every sequence of the reference its planted
    variants and two haplotypes; and the reads as the program receives
    them, each with the sequence, haplotype, start on that haplotype and
    strand it was drawn from."""

    variants: list  # per sequence: [Variant]
    haps: list  # per sequence: [(hap codes, hap -> ref map)] x 2
    codes: np.ndarray  # (n, Lp) int8, as sequenced (reverse reads flipped)
    lengths: np.ndarray
    seq_of: np.ndarray  # (n,) index of the sequence of each read
    hap_of: np.ndarray  # (n,) haplotype of each read
    start: np.ndarray  # (n,) 0-based start on that haplotype
    reverse: np.ndarray
    names: list[str]
    base_quality: int

    def __len__(self) -> int:
        return len(self.lengths)


def sample_seeds(seed: int, k: int, n_seqs: int) -> list[int]:
    """3 * n_seqs + 1 seeds for the k-th sample of a run's seed: each
    sequence's individual and its two haplotypes' reads, then the order of
    the reads."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(k)])
    return [int(x) for x in ss.generate_state(3 * n_seqs + 1, np.uint64)]


def reads_per_haplotype(length: int, sample_cfg: dict) -> int:
    """Reads drawn from each haplotype of a sequence: half of the
    configuration's coverage of it."""
    return round(sample_cfg["coverage"] * length / sample_cfg["read_length"] / 2)


def make_sample(ref: Reference, sample_cfg: dict, seed: int, k: int = 0) -> Sample:
    """The k-th sample of `seed`: a diploid individual of every sequence,
    and reads_per_haplotype reads from each of its haplotypes, shuffled.
    Every seed gives the same number of reads from each sequence."""
    seeds = sample_seeds(seed, k, len(ref.seqs))
    variants, haps, parts = [], [], []
    for i, (name, seq) in enumerate(zip(ref.names, ref.seqs)):
        s_ind, s_r0, s_r1 = seeds[3 * i : 3 * i + 3]
        var = simulate_individual(seq, sample_cfg["snv_rate"], sample_cfg["indel_rate"], s_ind)
        hs = haplotypes(seq, var)
        variants.append(var)
        haps.append(hs)
        n = reads_per_haplotype(len(seq), sample_cfg)
        for h, ((hap, _), s) in enumerate(zip(hs, (s_r0, s_r1))):
            codes, start, reverse, names = simulate_reads(
                hap, n, sample_cfg["read_length"], sample_cfg["error_rate"], s, name)
            parts.append((codes, start, reverse, names, i, h))
    n_all = sum(len(p[1]) for p in parts)
    order = np.random.default_rng(seeds[-1]).permutation(n_all)
    names = [nm for p in parts for nm in p[3]]
    return Sample(
        variants=variants,
        haps=haps,
        codes=np.concatenate([p[0] for p in parts])[order],
        lengths=np.full(n_all, sample_cfg["read_length"], np.int32),
        seq_of=np.concatenate([np.full(len(p[1]), p[4], np.int16) for p in parts])[order],
        hap_of=np.concatenate([np.full(len(p[1]), p[5], np.int8) for p in parts])[order],
        start=np.concatenate([p[1] for p in parts])[order],
        reverse=np.concatenate([p[2] for p in parts])[order],
        names=[names[j] for j in order],
        base_quality=sample_cfg["base_quality"],
    )


def repeat_mask(length: int, repeat_iv: np.ndarray, pad: int) -> np.ndarray:
    """bench.check_accuracy's `in_repeat`: True on 0-based positions within
    `pad` bases of a repeat interval (length + 2 entries)."""
    in_repeat = np.zeros(length + 2, bool)
    for lo, hi in repeat_iv:
        in_repeat[max(0, lo - pad) : hi + pad] = True
    return in_repeat
