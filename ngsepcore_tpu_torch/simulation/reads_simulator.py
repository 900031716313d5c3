"""Read simulator with error profiles.

Ref: src/ngsep/simulation/SingleReadsSimulator.java (command
`SingleReadsSimulator`): uniform read sampling from a genome with
substitution/indel errors; read names encode the truth placement as
`<seqName>_<first1based>_<reverse>_<i>` (SingleReadsSimulator.java:229),
which the mapping-accuracy benchmark parses
(QualityStatisticsAlignmentSimulatedReads.java:57).
"""
from __future__ import annotations

import numpy as np

from ..core.genome import ReferenceGenome
from ..core.sequences import RawRead, decode_dna, reverse_complement_codes


class SingleReadsSimulator:
    def __init__(
        self,
        genome: ReferenceGenome,
        read_length: int = 100,
        substitution_error_rate: float = 0.005,
        indel_error_rate: float = 0.0,
        seed: int = 1,
        base_quality: int = 40,
    ):
        self.genome = genome
        self.read_length = read_length
        self.substitution_error_rate = substitution_error_rate
        self.indel_error_rate = indel_error_rate
        self.rng = np.random.default_rng(seed)
        self.base_quality = base_quality

    def simulate(self, num_reads: int) -> list[RawRead]:
        reads: list[RawRead] = []
        g = self.genome
        L = self.read_length
        # sample sequences weighted by length
        lengths = np.diff(g.offsets).astype(np.float64)
        ok = lengths >= L
        probs = np.where(ok, lengths, 0.0)
        probs = probs / probs.sum()
        qual_char = chr(33 + self.base_quality)
        for i in range(num_reads):
            si = int(self.rng.choice(len(lengths), p=probs))
            seq_len = int(lengths[si])
            start = int(self.rng.integers(0, seq_len - L + 1))  # 0-based
            codes = g.codes(si, start + 1, start + L).copy()
            reverse = bool(self.rng.random() < 0.5)
            # substitution errors
            if self.substitution_error_rate > 0:
                errs = self.rng.random(L) < self.substitution_error_rate
                idx = np.nonzero(errs)[0]
                if len(idx):
                    shift = self.rng.integers(1, 4, size=len(idx)).astype(np.int8)
                    codes[idx] = np.where(
                        codes[idx] < 4, (codes[idx] + shift) % 4, codes[idx]
                    )
            if reverse:
                codes = reverse_complement_codes(codes)
            name = f"{g.sequence_name(si)}_{start + 1}_{reverse}_{i + 1}"
            reads.append(
                RawRead(name=name, sequence=decode_dna(codes), qualities=qual_char * L)
            )
        return reads


def _simulate_block(self, num_reads: int) -> "ReadBlock":
    """Vectorized simulate() emitting one dense ReadBlock: same read model
    (uniform placement, substitution errors, half reverse-complemented,
    truth-encoding names), no per-read Python objects on the hot path."""
    from ..core.sequences import ReadBlock

    g = self.genome
    L = self.read_length
    rng = self.rng
    n = num_reads
    seq_lengths = np.diff(g.offsets).astype(np.float64)
    ok = seq_lengths >= L
    probs = np.where(ok, seq_lengths, 0.0)
    probs = probs / probs.sum()
    si = rng.choice(len(seq_lengths), size=n, p=probs)
    start = (rng.random(n) * (seq_lengths[si] - L + 1)).astype(np.int64)
    cstart = g.offsets[si] + start
    codes = g.concat[cstart[:, None] + np.arange(L, dtype=np.int64)[None, :]]
    codes = codes.astype(np.int8, copy=True)
    if self.substitution_error_rate > 0:
        errs = rng.random((n, L)) < self.substitution_error_rate
        shift = rng.integers(1, 4, size=(n, L)).astype(np.int8)
        codes = np.where(
            errs & (codes < 4), (codes + shift) % 4, codes
        ).astype(np.int8)
    reverse = rng.random(n) < 0.5
    flipped = codes[:, ::-1]
    flipped = np.where(flipped < 4, 3 - flipped, flipped).astype(np.int8)
    codes = np.where(reverse[:, None], flipped, codes)
    Lp = -(-L // 16) * 16
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)), constant_values=4)
    names = [
        f"{g.sequence_name(int(s))}_{int(p) + 1}_{bool(r)}_{i + 1}"
        for i, (s, p, r) in enumerate(zip(si, start, reverse))
    ]
    return ReadBlock(
        codes,
        np.full(n, L, np.int32),
        None,
        names,
        default_quality=self.base_quality,
    )


# bound as a method (defined at module level to keep the class body short)
SingleReadsSimulator.simulate_block = _simulate_block


def parse_simulated_read_name(name: str) -> tuple[str, int, bool]:
    """Inverse of the truth encoding: (seq_name, first 1-based, reverse)."""
    items = name.split("_")
    reverse = items[-2] == "True" or items[-2] == "true"
    first = int(items[-3])
    seq_name = "_".join(items[:-3])
    return seq_name, first, reverse
