"""The control and the faults: outputs that the comparison must refuse.

- `control_records`: the plain reference put in the program's place,
  computed one precision below what the configuration states: every
  position of every sequence that the truth pileup shows a non-reference
  base at, genotyped in float32 instead of float64.  It calls SNVs only.
- The faults break the timed path underneath the harness (each wraps the
  program's per-sample call): half of each sample's reads left out, an SNV
  answer altered where it is produced, the indel answers moved, every
  indel's genotype flipped between heterozygous and homozygous, and a run
  that returns no answer.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import reference

MOVE_BP = 20  # far past the 5 bp within which an indel call counts as found


def _record(seq_name, first, alleles, gt, gq, qual, depths, pl):
    variant = SimpleNamespace(sequence_name=seq_name, first=first, alleles=list(alleles),
                              quality=qual)
    call = SimpleNamespace(indexes_called_alleles=list(gt), genotype_quality=gq,
                           total_read_depth=int(sum(depths)), acgt_depths=list(depths),
                           genotype_likelihoods=pl)
    return SimpleNamespace(variant=variant, calls=[call])


def control_records(ref, sample, cfg: dict, dtype=np.float32) -> list:
    """The reference's SNV records in `dtype` over every sequence."""
    call = cfg["caller"]
    out = []
    for si, (name, seq) in enumerate(zip(ref.names, ref.seqs)):
        counts = reference.truth_pileup(sample, si, seq, np.arange(len(seq)))
        ref_codes = seq.astype(np.int64)
        nonref = counts.sum(axis=1) - counts[np.arange(len(seq)), np.minimum(ref_codes, 3)]
        pos = np.nonzero((nonref > 0) & (ref_codes < 4))[0]
        g = reference.genotype(counts[pos], ref_codes[pos],
                               base_quality=cfg["sample"]["base_quality"],
                               het_rate=call["heterozygosity_rate"],
                               min_quality=call["min_quality"], dtype=dtype)
        for k in np.nonzero(g["emit"])[0]:
            p = int(pos[k])
            idxs, gt = reference.called_alleles(int(ref_codes[p]), int(g["bi"][k]),
                                                int(g["bj"][k]))
            pl, _ = reference.phred_likelihoods(g["logcond"][k].astype(np.float64), idxs)
            out.append(_record(name, p + 1, ["ACGT"[i] for i in idxs], gt, int(g["gq"][k]),
                               int(g["qual"][k]), [int(x) for x in counts[p]], pl))
    return out


def half_reads(run):
    """Every second read of the sample left out."""
    def broken(reads):
        from ngsepcore_tpu_torch.core.sequences import ReadBlock

        return run(ReadBlock(np.ascontiguousarray(reads.codes[::2]), reads.lengths[::2].copy(),
                             None, reads.names[::2], default_quality=reads.default_quality))
    return broken


def snv_answer_altered(run):
    """The first SNV record's GQ one higher than the program made it."""
    def broken(reads):
        records = run(reads)
        for rec in records:
            if len(rec.variant.alleles[0]) == 1 and len(rec.variant.alleles[1]) == 1:
                rec.calls[0].genotype_quality += 1
                break
        return records
    return broken


def indels_moved(run):
    """Every indel record MOVE_BP bases past where the program put it."""
    def broken(reads):
        records = run(reads)
        for rec in records:
            if any(len(a) != 1 for a in rec.variant.alleles):
                rec.variant.first += MOVE_BP
        return records
    return broken


def indel_genotype_flipped(run):
    """Every indel record's genotype flipped: 0/1 to homozygous for the
    first alternative, and any other to 0/1."""
    def broken(reads):
        records = run(reads)
        for rec in records:
            if any(len(a) != 1 for a in rec.variant.alleles):
                gt = rec.calls[0].indexes_called_alleles
                rec.calls[0].indexes_called_alleles = [1] if list(gt) == [0, 1] else [0, 1]
        return records
    return broken


def no_answer(run):
    """The sample is run, and nothing comes back."""
    def broken(reads):
        run(reads)
        return []
    return broken


FAULTS = {"half_reads": half_reads, "snv_answer_altered": snv_answer_altered,
          "indels_moved": indels_moved, "indel_genotype_flipped": indel_genotype_flipped,
          "no_answer": no_answer}
