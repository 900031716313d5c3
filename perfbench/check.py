"""The comparison that decides `correct`.

The program's output for one sample is its list of VCF records, which the
window turns into text as it ends each sample (`compact`: the fields judged
here, a line a record).  They are judged against the plain reference
(reference.py) and the simulator's truth, which the benchmark made itself:

- `gl_mismatch`: SNV records whose alleles, genotype, GQ, QUAL or
  phred-scaled likelihoods differ from the genotype model run in float64
  on the record's own allele counts (a difference that a rounding tie
  explains is not counted).  This follows the program from its own
  counts; `depth_mismatch_pct` checks the counts.
- `depth_mismatch_pct`: of the SNV records at unique positions, and every
  SNV record on a sequence the reference does not have, the share whose
  A, C, G, T counts differ from the truth pileup.
- `snv_missed_pct`: of the planted SNVs at unique positions that the model
  calls from the truth pileup, the share with no record of the same
  sequence, position, alleles and genotype.
- `indel_missed_pct`, `indel_false_pct`: bench.check_accuracy's indel
  recall in unique regions and indel precision (5 bp), as shares missed,
  matched on the same sequence.
- `indel_wrong_pct`: of the planted indels in unique regions that a called
  indel lies within 5 bp of, the share whose nearest called indel does not
  give the planted haplotypes: the sequences that its called alleles make
  of the reference around both differ from those of the planted alleles
  and genotype (so a left-shifted but equal indel is right).

Each number has its limit in perfbench/limits/<workload>.json; the run is
correct when no number exceeds its limit.
"""
from __future__ import annotations

import numpy as np

from . import reference
from .inputs import repeat_mask

BASE_CODE = {b: i for i, b in enumerate("ACGT")}
ROUNDING_TIE = 1e-6  # an unrounded value this close to .5 may round either way
DECISION_TIE = 1e-9  # a genotype this close to the +0.01 margin may go either way


def _is_snv(alleles) -> bool:
    return len(alleles) > 1 and all(len(a) == 1 and a in BASE_CODE for a in alleles)


def _tie(raw: float) -> bool:
    return abs(raw - np.floor(raw) - 0.5) < ROUNDING_TIE


def gl_mismatches(snvs: list, seqs: dict, model: dict) -> int:
    """SNV records that the float64 model, given their own counts, does
    not reproduce."""
    if not snvs:
        return 0
    depths = np.array([s["depths"] for s in snvs], np.int64)
    refs = np.array([seqs[s["seq"]][s["first"] - 1] for s in snvs], np.int64)
    g = reference.genotype(depths, refs, **model)
    bad = 0
    for k, s in enumerate(snvs):
        if g["margin"][k] < DECISION_TIE:
            continue
        r, bi, bj = int(refs[k]), int(g["bi"][k]), int(g["bj"][k])
        idxs, gt = reference.called_alleles(r, bi, bj)
        pl, pl_raw = reference.phred_likelihoods(g["logcond"][k], idxs)
        fields = [
            (s["alleles"] == tuple("ACGT"[i] for i in idxs) and s["gt"] == gt, None),
            (s["gq"] == g["gq"][k], g["gq_raw"][k]),
            (s["qual"] == g["qual"][k], g["qual_raw"][k]),
        ]
        if not bool(g["emit"][k]):
            fields.append((False, None))
        ok = all(same or (raw is not None and _tie(raw)) for same, raw in fields)
        if ok and s["pl"] != pl:
            ok = len(s["pl"]) == len(pl) and all(
                a == b or (abs(a - b) == 1 and _tie(raw))
                for a, b, raw in zip(s["pl"], pl, pl_raw)
            )
        bad += not ok
    return bad


def _near(queries: np.ndarray, targets: np.ndarray, tol: int = 5) -> np.ndarray:
    """bench.check_accuracy's _near: within tol of some sorted target."""
    if len(queries) == 0 or len(targets) == 0:
        return np.zeros(len(queries), bool)
    j = np.searchsorted(targets, queries)
    near = np.zeros(len(queries), bool)
    for d in (0, 1):
        for k in (np.clip(j - d, 0, len(targets) - 1), np.clip(j + d, 0, len(targets) - 1)):
            near |= np.abs(targets[k] - queries) <= tol
    return near


def compact(records) -> str:
    """One sample's records as text, a tab-separated line a record:
    sequence, position, alleles, called allele indexes, GQ, QUAL rounded,
    A/C/G/T depths, phred-scaled likelihoods."""
    def ints(xs):
        return ",".join(str(int(x)) for x in (xs or ()))

    return "\n".join(
        "\t".join((rec.variant.sequence_name, str(int(rec.variant.first)),
                   ",".join(rec.variant.alleles), ints(rec.calls[0].indexes_called_alleles),
                   str(int(rec.calls[0].genotype_quality)), str(int(round(rec.variant.quality))),
                   ints(rec.calls[0].acgt_depths), ints(rec.calls[0].genotype_likelihoods)))
        for rec in records
    )


def parse(text: str) -> tuple[list, list]:
    """The SNV records and the other (indel) records of compact text, as
    plain dicts."""
    snvs, indels = [], []
    for line in text.split("\n") if text else ():
        seq, first, alleles, gt, gq, qual, depths, pl = line.split("\t")
        alleles = tuple(alleles.split(","))
        gt = tuple(int(x) for x in gt.split(",") if x)
        if _is_snv(alleles):
            snvs.append(dict(
                seq=seq, first=int(first), alleles=alleles, gt=gt, gq=int(gq), qual=int(qual),
                depths=tuple(int(x) for x in depths.split(",") if x) or (0, 0, 0, 0),
                pl=[int(x) for x in pl.split(",") if x],
            ))
        else:
            indels.append(dict(seq=seq, first=int(first), alleles=alleles, gt=gt))
    return snvs, indels


def _decode(codes) -> str:
    return "".join("ACGTN"[min(int(c), 4)] for c in codes)


def indel_haplotypes(seq: np.ndarray, lo: int, hi: int, first: int, alleles, gt):
    """The sequences that a genotype's alleles make of seq[lo:hi], as a
    frozenset; None when the first allele is not the reference there."""
    p0, ref = first - 1, alleles[0]
    if p0 < lo or p0 + len(ref) > hi or _decode(seq[p0 : p0 + len(ref)]) != ref:
        return None
    left, right = _decode(seq[lo:p0]), _decode(seq[p0 + len(ref) : hi])
    return frozenset(left + alleles[i] + right for i in gt)


FLANK = 20  # bases of the reference kept on each side of two compared indels


def indel_agrees(seq: np.ndarray, planted, called: dict) -> bool:
    """Whether a called indel record gives the planted indel's haplotypes."""
    a, b = planted.first - 1, called["first"] - 1
    lo = max(0, min(a, b) - FLANK)
    hi = min(len(seq), max(a + len(planted.ref), b + len(called["alleles"][0])) + FLANK)
    want = indel_haplotypes(seq, lo, hi, planted.first, (planted.ref, planted.alt),
                            (1, 1) if not planted.het else (0, 1))
    got = indel_haplotypes(seq, lo, hi, called["first"], called["alleles"], called["gt"])
    return got is not None and got == want


class Judge:
    """Judges the records of one sample.  Built once a sample: the truth
    pileup at every position a record or a planted SNV names is computed
    on first use and kept."""

    def __init__(self, ref, sample, cfg: dict):
        self.sample = sample
        self.seqs = dict(zip(ref.names, ref.seqs))
        self.index = {name: i for i, name in enumerate(ref.names)}
        pad = cfg["sample"]["read_length"]
        self.in_repeat = {name: repeat_mask(len(seq), iv, pad)
                          for name, seq, iv in zip(ref.names, ref.seqs, ref.repeat_iv)}
        call = cfg["caller"]
        self.model = dict(base_quality=cfg["sample"]["base_quality"],
                          het_rate=call["heterozygosity_rate"], min_quality=call["min_quality"])
        self.truth_snv = {n: [v for v in var if v.is_snv]
                          for n, var in zip(ref.names, sample.variants)}
        self.truth_indel = {n: sorted((v for v in var if not v.is_snv), key=lambda v: v.first)
                            for n, var in zip(ref.names, sample.variants)}
        self._pile: dict[str, dict[int, np.ndarray]] = {n: {} for n in ref.names}
        self._expected = None

    def pileup(self, name: str, firsts) -> np.ndarray:
        """Truth counts at 1-based positions of one sequence; the first call
        also counts every planted SNV's position there, so one pass over
        the sequence's reads serves a sample."""
        pile = self._pile[name]
        need = {int(p) for p in firsts} - pile.keys()
        if need:
            if not pile:
                need |= {v.first for v in self.truth_snv[name]}
            need = sorted(need)
            got = reference.truth_pileup(self.sample, self.index[name], self.seqs[name],
                                         np.array(need) - 1)
            pile.update(zip(need, got))
        return np.array([pile[int(p)] for p in firsts], np.int64).reshape(-1, 4)

    def expected_snvs(self) -> dict:
        """{(sequence, first): (alleles, gt)} the model calls from the truth
        pileup at the planted SNVs in unique sequence."""
        if self._expected is None:
            exp = {}
            for name, snvs in self.truth_snv.items():
                firsts = [v.first for v in snvs if not self.in_repeat[name][v.first]]
                if not firsts:
                    continue
                depths = self.pileup(name, firsts)
                refs = self.seqs[name][np.array(firsts) - 1].astype(np.int64)
                g = reference.genotype(depths, refs, **self.model)
                for k, p in enumerate(firsts):
                    if g["emit"][k]:
                        idxs, gt = reference.called_alleles(int(refs[k]), int(g["bi"][k]),
                                                            int(g["bj"][k]))
                        exp[name, p] = (tuple("ACGT"[i] for i in idxs), gt)
            self._expected = exp
        return self._expected

    def numbers(self, text: str) -> dict:
        snvs, indels = parse(text)
        known = [s for s in snvs if s["seq"] in self.seqs]
        elsewhere = len(snvs) - len(known)
        out = {"gl_mismatch": gl_mismatches(known, self.seqs, self.model) + elsewhere}
        here = [s for s in known if not self.in_repeat[s["seq"]][s["first"]]]
        differ = elsewhere
        for name in {s["seq"] for s in here}:
            mine = [s for s in here if s["seq"] == name]
            truth = self.pileup(name, [s["first"] for s in mine])
            prog = np.array([s["depths"] for s in mine], np.int64).reshape(-1, 4)
            differ += int((truth != prog).any(axis=1).sum())
        out["depth_mismatch_pct"] = 100.0 * differ / max(1, len(here) + elsewhere)
        exp = self.expected_snvs()
        got = {(s["seq"], s["first"]): (s["alleles"], s["gt"]) for s in here}
        missed = sum(got.get(key) != e for key, e in exp.items())
        out["snv_missed_pct"] = 100.0 * missed / max(1, len(exp))
        out.update(self.indel_numbers(indels))
        return out

    def indel_numbers(self, indels: list) -> dict:
        unique = found = false = wrong = 0
        for name, planted in self.truth_indel.items():
            called = sorted((r for r in indels if r["seq"] == name), key=lambda r: r["first"])
            at = np.array([r["first"] for r in called], np.int64)
            truth_at = np.array([v.first for v in planted], np.int64)
            false += int((~_near(at, truth_at)).sum())
            for v in planted:
                if self.in_repeat[name][v.first]:
                    continue
                unique += 1
                if not len(at):
                    continue
                j = int(np.argmin(np.abs(at - v.first)))
                if abs(int(at[j]) - v.first) > 5:
                    continue
                found += 1
                wrong += not indel_agrees(self.seqs[name], v, called[j])
        false += sum(r["seq"] not in self.seqs for r in indels)
        return {
            "indel_missed_pct": 100.0 * (1 - found / unique) if unique else 0.0,
            "indel_false_pct": 100.0 * false / len(indels) if indels else 0.0,
            "indel_wrong_pct": 100.0 * wrong / found if found else 0.0,
        }


def judge_run(judges: list, outputs: list) -> dict:
    """The worst of each number over the samples of a run; `outputs` holds
    (index of the sample's judge, compact records) a sample."""
    worst: dict = {}
    for k, text in outputs:
        for name, v in judges[k].numbers(text).items():
            worst[name] = max(worst.get(name, v), v)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, one line a number: name, value, limit).  A number without
    a limit fails."""
    lines, ok = [], True
    for name in sorted(numbers):
        v, lim = numbers[name], limits.get(name)
        good = lim is not None and v <= lim
        ok &= good
        lines.append(f"{name} {v!r} limit {lim!r}{'' if good else ' FAILED'}")
    return ok, lines
