"""Genotype likelihood + posterior math: the classic detector's count
scatter and screened genotyper, the span-scatter genotyper and the
shear-histogram genotyper.

Ref: src/ngsep/discovery/CountsHelper.java — constants :42-48 (het rate
diploid 0.001, DEF_NUM_FREQUENCIES=501, min base q=3 excluded, max clamp
30, indel log error 1e-4), probability caches :135-185, per-call SNV
update :209-251, posterior with 1e-20 truncation :480-495 — and
VariantDiscoverySNVQAlgorithm.java:21-265 (genotype decision with +0.01
margins, GQ=0 => undecided, variant QS = phred(post[ref][ref])).

Each call's contribution depends only on (observed allele a, base
quality q), so the per-position log-conditional matrix is a contraction

    logcond[p,i,j] = sum_{a,q} counts[p,a,q] * C[a,q,i,j]

Three genotypers share that math and differ in how counts arrive:

- genotype_window_sparse: flat (W, 4*31) counts scattered from packed
  host calls (accumulate_allele_counts_packed), the classic detector;
- genotype_window_span: a (W, 128) combined tensor scattered from a span
  of the fused pipeline's compacted device-path reads plus packed host
  calls, for runs the histogram path cannot bin (> 29 qualities);
- genotype_window_hist: the shear-histogram pileup (kernels/shear_pileup).

genotype_posteriors gives the posteriors of every position of a count
tensor, unscreened (the mesh's sharded_call_step, distribute/mesh.py).

Each screens every position in float32 and recomputes only the flagged
positions exactly (_screen_flag, _exact_sites).  Integer scatters
(index_add_ on int32) give the same counts in any order.

Numerics on the card: the screen's flagged set depends on float32
matmul accuracy (0.01 slack), so callers must keep TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False, float32 matmul precision
"highest"); the genotypers refuse to run otherwise.  The exact stage
contracts in float64 natively (the JAX default path's two-float f32 pair
exists only for the TPU).  Flagged and interesting sites come from
torch.nonzero in ascending order, so the JAX package's fixed-size
max_flag/max_out buffers and their grow-and-retry pass (_needs_retry,
_grown_bounds and the *_resolved/*_resolve_batch wrappers) have no
counterpart: every window returns all its sites at once, and
genotype_window_hist_resolve_batch only copies results to the host.  Each
nonzero is a host sync.
"""
from __future__ import annotations

import numpy as np
import torch

from .shear_pileup import (
    STRAND_COL0,
    hist_packed_scatter,
    hist_residual_scatter,
    shear_hist,
)

HET_RATE_DIPLOID = 0.001  # ref: CountsHelper.java:42
HET_RATE_HAPLOID = 1e-6
MIN_BASE_QS = 3  # calls with q<=3 excluded (ref :214-216)
MAX_BASE_QS = 30  # clamp (ref :217-218)
NUM_FREQ = 501
LOG_ERROR_PROB_INDEL = float(np.log10(1e-4))
N_QBINS = MAX_BASE_QS + 1  # quality axis 0..30 after clamping
COL_N, COL_LOW, N_COLS = 124, 125, 128  # dense (allele x 31-qual) layout
META_PRED, META_CS, META_CE, META_STRAND, META_LEN, META_COLS = 0, 1, 2, 3, 4, 8


def _log_caches(n_alleles: int, het_proportion: float = 0.5):
    """Numpy mirrors of logProbCacheError / logProbCacheGT rows used for SNVs."""
    q = np.arange(N_QBINS, dtype=np.float64)
    err_prob = 10.0 ** (-0.1 * q)
    log_err0 = -0.1 * q  # logProbCacheError[q][0]
    log_err_n = log_err0 - np.log10(n_alleles - 1)  # logProbCacheError[q][n]
    # f and g grid indices exactly like the reference rounding (ref :211-212;
    # Java Math.round is half-up)
    f = int(np.floor(het_proportion * (NUM_FREQ - 1) + 0.5))
    g = int(np.floor((1 - het_proportion) * (NUM_FREQ - 1) + 0.5))
    af_f = f / (NUM_FREQ - 1)
    af_g = g / (NUM_FREQ - 1)
    success = 1 - err_prob
    with np.errstate(divide="ignore"):  # q=0 rows are masked out below
        log_gt0 = np.log10(success)  # logProbCacheGT[*][q][0]
        log_gt_f = np.log10(af_f * success + (1 - af_f) * err_prob / (n_alleles - 1))
        log_gt_g = np.log10(af_g * success + (1 - af_g) * err_prob / (n_alleles - 1))
    return log_err0, log_err_n, log_gt0, log_gt_f, log_gt_g


def snv_contribution_table(n_alleles: int = 4, het_proportion: float = 0.5) -> np.ndarray:
    """C[a, q, i, j]: contribution of one call (allele a, quality q) to the
    log-conditional of ordered genotype (i,j).  Mirrors the update loop at
    CountsHelper.java:231-249."""
    log_err0, log_err_n, log_gt0, log_gt_f, log_gt_g = _log_caches(
        n_alleles, het_proportion
    )
    n = n_alleles
    C = np.zeros((n, N_QBINS, n, n), dtype=np.float64)
    for a in range(n):
        for i in range(n):
            for j in range(n):
                if i == j:
                    C[a, :, i, j] = log_gt0 if i == a else log_err_n
                elif j == a:
                    C[a, :, i, j] = log_gt_f
                elif i == a:
                    C[a, :, i, j] = log_gt_g
                else:
                    C[a, :, i, j] = log_err_n
    # calls with q <= MIN_BASE_QS are excluded entirely (ref :214-216)
    C[:, : MIN_BASE_QS + 1, :, :] = 0.0
    return C


def expand_mrun_calls(
    run_ref: torch.Tensor,  # (R,) int32 1-based seq position of each M-run start
    run_src: torch.Tensor,  # (R,) int32 offset of the run's first base in codes_flat
    run_len: torch.Tensor,  # (R,) int32 run length (ig5/ig3 trims pre-applied)
    run_strand: torch.Tensor,  # (R,) int32 1 = negative strand
    codes_flat: torch.Tensor,  # (C,) int8 concatenated read codes
    qflat: torch.Tensor,  # (C,) int8 per-base phred quals
    *,
    N: int,
):
    """Expand per-alignment M-runs into position-sorted packed base calls
    on device (one segmented expand + one stable sort).

    Returns (pos (N,) int32 ascending 1-based, attr (N,) int32, total):
    attr = qual(5b) | allele(3b)<<5 | strand<<8 — shifted left 20 at
    window-slice time it is the hist kernel's pk layout.  Slots past
    `total` carry pos=2^30-1 / attr=-1 so they sort last."""
    dev = run_len.device
    R = run_len.shape[0]
    cum = torch.cumsum(run_len.to(torch.int64), dim=0)
    total = cum[-1]
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    rid = torch.searchsorted(cum, idx, right=True)
    ridc = torch.clamp(rid, 0, R - 1)
    o = idx - (cum[ridc] - run_len[ridc].to(torch.int64))
    valid = idx < total
    pos = torch.where(valid, run_ref[ridc].to(torch.int64) + o, 0x3FFFFFFF)
    src = torch.clamp(run_src[ridc].to(torch.int64) + o, 0, codes_flat.shape[0] - 1)
    code = torch.clamp(codes_flat[src].to(torch.int32), 0, 7)
    qq = torch.clamp(qflat[src].to(torch.int32), 0, MAX_BASE_QS)
    attr = qq | (code << 5) | (run_strand[ridc].to(torch.int32) << 8)
    attr = torch.where(valid, attr, -1)
    pos = pos.to(torch.int32)
    order = torch.sort(pos, stable=True).indices
    return pos[order], attr[order], total


def window_pk_slice(pos, attr, lo: int, w0: int, count: int, *, size: int):
    """Per-window packed-call buffer from the sorted call arrays:
    pk[i] = (pos[lo+i] - w0) | attr[lo+i] << 20 for i < count, -1 padding
    to `size`."""
    k = torch.arange(size, dtype=torch.int64, device=pos.device)
    idx = torch.clamp(lo + k, 0, pos.shape[0] - 1)
    a = attr[idx]
    pk = (pos[idx] - w0) | (a << 20)
    return torch.where((k < count) & (a >= 0), pk, -1).to(torch.int32)


def _tf32_off() -> bool:
    return (
        not torch.backends.cuda.matmul.allow_tf32
        and torch.get_float32_matmul_precision() == "highest"
    )


def _require_full_f32(t: torch.Tensor) -> None:
    if t.device.type == "cuda" and not _tf32_off():
        raise RuntimeError(
            "TF32 matmul must be off: the float32 screen decides which "
            "positions reach the exact stage"
        )


def _screen_flag(ev32, ref, depth, total, het_rate: float, n: int):
    """Stage 1: flag positions whose decision COULD differ from
    homozygous-reference, from the float32 evidence ev32 (P, n*n).  The
    slack (0.01 + 1e-4 * depth) covers float32 numerical error only: when
    the best non-reference pair evidence is below the reference's by
    more, the +0.01 decision margin cannot be met."""
    G = n * n
    dev = ev32.device
    eye_flat = np.eye(n, dtype=bool).reshape(-1)
    log_prior_hetero32 = np.float32(np.log10(het_rate / (n * (n - 1))))
    log_prior_homo32 = np.float32(np.log10((1 - het_rate) / n))
    prior32 = np.where(eye_flat, log_prior_homo32, log_prior_hetero32).astype(
        np.float32
    )
    # unordered-pair evidence: a het posterior sums both orders (+log10 2)
    pair32 = prior32 + np.where(eye_flat, 0.0, np.log10(2.0)).astype(np.float32)
    ev_pair = ev32 + torch.from_numpy(pair32).to(dev)[None, :]
    gidx = torch.arange(G, device=dev)[None, :]
    is_ref_gt = gidx == (ref * (n + 1))[:, None]
    ref_ev = torch.where(is_ref_gt, ev_pair, 0.0).sum(dim=1)
    best_ev = torch.amax(
        torch.where(is_ref_gt, float("-inf"), ev_pair), dim=1
    )
    # float32 constants as Python floats (torch then computes in float32)
    slack = depth.to(torch.float32) * float(np.float32(1e-4)) + float(
        np.float32(0.01)
    )
    return (best_ev >= ref_ev - slack) & (total > 0)


def _sum_genotypes(flat: torch.Tensor) -> torch.Tensor:
    """Row sums of (F, G >= 4) in a fixed order of elementwise additions:
    four running sums over columns g, g+4, g+8, ... then (s0+s2)+(s1+s3),
    then any columns left over.  From GQ ~120 up the last bits of this
    sum decide 1 - best, and a library reduction orders its additions by
    device; written out, the CPU and the card round alike.  For G = 16 this
    is the order XLA:CPU takes for the JAX package's jnp.sum (four vector
    lanes, then a pairwise fold): the GQs of 40,960 sites equal the JAX
    package's (tests/test_torch_multisample.py)."""
    G = flat.shape[1]
    acc = flat[:, :4]
    for g in range(4, G - 3, 4):
        acc = acc + flat[:, g : g + 4]
    out = (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])
    for g in range(G - G % 4, G):
        out = out + flat[:, g]
    return out


def _posteriors(logcond, het_rate: float, n: int):
    """(F, n, n) float64 posteriors from float64 logcond (F, n, n): the
    homozygous and heterozygous log priors, the shift by each row's
    maximum, the 1e-20 truncation and the normalisation
    (CountsHelper.java:480-495)."""
    F = logcond.shape[0]
    prior = torch.from_numpy(
        np.where(
            np.eye(n, dtype=bool),
            np.log10((1 - het_rate) / n),
            np.log10(het_rate / (n * (n - 1))),
        )
    ).to(logcond.device)
    ev = logcond + prior[None, :, :]
    logmax = torch.amax(ev.reshape(F, n * n), dim=1)[:, None, None]
    rel = ev - logmax
    p = torch.where(rel < -20.0, 0.0, torch.pow(10.0, rel))
    return p / _sum_genotypes(p.reshape(F, n * n))[:, None, None]


def _posterior_decision(logcond, refs, het_rate: float, n: int):
    """Posteriors (_posteriors), the genotype decision with +0.01 margins
    (VariantDiscoverySNVQAlgorithm.getIndexesMaxGenotype) and GQ for F
    positions, from float64 logcond (F, n, n) and clamped reference
    alleles refs (F,).  Returns (bi, bj, gq int32, ref_prob)."""
    dev = logcond.device
    F = logcond.shape[0]
    post = _posteriors(logcond, het_rate, n)
    frows = torch.arange(F, device=dev)
    best = post[frows, refs, refs]
    bi = refs
    bj = refs
    for i in range(n):
        for j in range(i, n):
            prob = post[:, i, j] + (post[:, j, i] if i != j else 0.0)
            upd = prob > best + 0.01
            best = torch.where(upd, prob, best)
            bi = torch.where(upd, i, bi)
            bj = torch.where(upd, j, bj)
    ref_prob = post[frows, refs, refs]
    one_minus = 1.0 - best
    gq = torch.where(
        one_minus <= 0,
        255.0,
        torch.clamp(
            torch.round(-10.0 * torch.log10(torch.clamp(one_minus, min=1e-30))),
            max=255.0,
        ),
    ).to(torch.int32)
    return bi, bj, gq, ref_prob


def _interesting(bi, bj, gq, refs, ref_codes, total, min_quality: int):
    """Decided non-homoref calls on an ACGT reference with GQ >=
    min_quality at covered positions."""
    return (
        ((bi != refs) | (bj != refs))
        & (ref_codes < 4)
        & (gq >= min_quality)
        & (gq > 0)
        & (total > 0)
    )


def _exact_sites(csub, Cd, refs, ref_codes_f, total_f, het_rate: float,
                 min_quality: int, n: int):
    """Stage 2 on the F flagged positions: float64 logcond = csub @ Cd,
    the posterior decision, and the interesting sites.  Returns (sidx, bi,
    bj, gq, ref_prob, logcond), sidx indexing the flagged rows and the rest
    already taken at sidx."""
    logcond = (csub @ Cd).reshape(csub.shape[0], n, n)
    bi, bj, gq, ref_prob = _posterior_decision(logcond, refs, het_rate, n)
    sidx = torch.nonzero(
        _interesting(bi, bj, gq, refs, ref_codes_f, total_f, min_quality)
    ).squeeze(1)
    return (
        sidx, bi[sidx].to(torch.int8), bj[sidx].to(torch.int8), gq[sidx],
        ref_prob[sidx], logcond[sidx],
    )


def _dense_table(contribution: torch.Tensor, n: int, rows: int):
    """(rows, n*n) float64 contraction table: the (allele, qbin) rows of
    the contribution table, zero rows past n*31 (N / low-quality / strand
    columns contribute nothing)."""
    G = n * n
    Cd = torch.zeros((rows, G), dtype=torch.float64, device=contribution.device)
    Cd[: n * N_QBINS] = contribution.reshape(n * N_QBINS, G)
    return Cd


# ---- classic detector: packed-call scatter + screened genotyper ---------

def init_count_tensors_flat(out_size: int, n_alleles: int = 4, *, device):
    """Zeroed flat-minor-axis accumulators (counts (W, n*31), strand
    counts (W, n*2), low-quality and total (W,)), int32 on `device`."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return (
        z(out_size, n_alleles * N_QBINS),
        z(out_size, n_alleles * 2),
        z(out_size),
        z(out_size),
    )


def _packed_fields(packed: torch.Tensor):
    """Unpack rel pos (bits 0-19), qual (20-24, pre-clamped 0..30), allele
    (25-27) and strand (28); negative words are skipped."""
    p = packed.to(torch.int64)
    valid = p >= 0
    rel = torch.where(valid, p & 0xFFFFF, 0)
    # valid words carry q <= 30 already; the clamp keeps the (zero-weight)
    # lanes of skipped words inside row 0
    q = torch.clamp((p >> 20) & 31, max=MAX_BASE_QS)
    return valid, rel, q, (p >> 25) & 7, (p >> 28) & 1


def accumulate_allele_counts_packed(counts, strand_counts, low_qual, total,
                                    packed: torch.Tensor):
    """Scatter packed calls into the flat count tensors IN PLACE (the JAX
    version donates and returns them; so does this one, for symmetry).

    N calls (allele 4) count only toward `total` and `low_qual`, the
    CountsHelper.updateCounts:209-220 semantics (the JAX scatter drops
    their out-of-range allele columns; here their weight is zero)."""
    if packed.numel():
        nq = counts.shape[1]
        valid, rel, q, al, st = _packed_fields(packed)
        low = valid & (q <= MIN_BASE_QS)
        ok = valid & (q > MIN_BASE_QS) & (al < 4)
        a3 = torch.clamp(al, max=3)
        counts.view(-1).index_add_(
            0, rel * nq + a3 * N_QBINS + q, ok.to(torch.int32)
        )
        strand_counts.view(-1).index_add_(
            0, rel * strand_counts.shape[1] + a3 * 2 + st, ok.to(torch.int32)
        )
        low_qual.index_add_(0, rel, low.to(torch.int32))
        total.index_add_(0, rel, valid.to(torch.int32))
    return counts, strand_counts, low_qual, total


def _screened_sites(counts, strand8, total, depth, ref_codes, contribution,
                    het_rate: float, min_quality: int, n: int) -> dict:
    """Screen + exact stage over a (W, K) int32 count tensor whose first
    n*31 columns are the dense (allele, qbin) counts (any further columns,
    N and low-quality calls, contract with zero rows).  strand8 is (W, 8)
    (allele, strand) counts, `depth` scales the screen's slack."""
    _require_full_f32(counts)
    ref_codes = ref_codes.to(torch.int64)
    ref = torch.clamp(ref_codes, 0, n - 1)
    Cd = _dense_table(contribution, n, counts.shape[1])
    flag = _screen_flag(
        counts.to(torch.float32) @ Cd.to(torch.float32), ref, depth, total,
        het_rate, n,
    )
    fidx = torch.nonzero(flag).squeeze(1)  # ascending
    csub = counts[fidx]
    sidx, bi, bj, gq, ref_prob, logcond = _exact_sites(
        csub.to(torch.float64), Cd, ref[fidx], ref_codes[fidx], total[fidx],
        het_rate, min_quality, n,
    )
    gsel = fidx[sidx]
    return {
        "site_idx": gsel.to(torch.int32),
        "n_sites": sidx.shape[0],
        "n_flagged": fidx.shape[0],
        "bi": bi,
        "bj": bj,
        "gq": gq,
        "ref_prob": ref_prob,
        "depths": csub[sidx][:, : n * N_QBINS].reshape(-1, n, N_QBINS).sum(dim=2),
        "total": total[gsel],
        "logcond": logcond,
        "strand_counts": strand8[gsel].reshape(-1, n, 2),
    }


def genotype_window_sparse(
    counts: torch.Tensor,  # (W, n*Q) int32 flat (allele, qbin) minor axis
    strand_counts: torch.Tensor,  # (W, n*2) int32
    total: torch.Tensor,  # (W,) int32
    ref_codes: torch.Tensor,  # (W,) int8
    contribution: torch.Tensor,  # (n, Q, n, n) float64
    het_rate: float,
    min_quality: int,
    n_alleles: int = 4,
) -> dict:
    """Screened genotyping of one count window: a float32 contraction over
    every position flags those whose decision could differ from
    homozygous-reference; the float64 math runs only on the flagged set.
    Returns device tensors, one row per interesting site (site_idx, bi,
    bj, gq, ref_prob, depths, total, logcond, strand_counts), plus
    n_sites and n_flagged."""
    # the slack scales with the quality-passing calls only
    return _screened_sites(
        counts, strand_counts, total, counts.sum(dim=1), ref_codes,
        contribution, het_rate, min_quality, n_alleles,
    )


# ---- multisample detector: sorted-call scatter + dense genotyper ---------

def scatter_allele_counts(
    positions: torch.Tensor,  # (N,) window-relative positions
    alleles: torch.Tensor,  # (N,) observed allele index (<0 = skip)
    quals: torch.Tensor,  # (N,) raw phred
    strands: torch.Tensor,  # (N,) 1 = negative
    n_alleles: int = 4,
    *,
    out_size: int,
):
    """(window, allele, qbin) counts, (window, allele, 2) strand counts,
    low-quality counts and totals of a list of calls, int32 on the inputs'
    device (ngsepcore_tpu.kernels.genotyping.scatter_allele_counts).

    A call counts where its allele is >= 0 and its position inside the
    window: in `total`, in `low_qual` at quality <= MIN_BASE_QS, else in the
    counts at its quality clamped to 0..MAX_BASE_QS.  The JAX version drops
    an update whose allele indexes past n_alleles; here such a call adds
    zero at a clamped index."""
    dev = positions.device
    pos = positions.to(torch.int64)
    al = alleles.to(torch.int64)
    qv = quals.to(torch.int64)
    valid = (al >= 0) & (pos >= 0) & (pos < out_size)
    q = torch.clamp(qv, 0, MAX_BASE_QS)
    low = valid & (qv <= MIN_BASE_QS)
    ok = (valid & (qv > MIN_BASE_QS) & (al < n_alleles)).to(torch.int32)
    p = torch.where(valid, pos, 0)
    a = torch.clamp(torch.where(valid, al, 0), max=n_alleles - 1)
    counts, strand_counts, low_qual, total = init_count_tensors(
        out_size, n_alleles, device=dev
    )
    counts.index_put_((p, a, q), ok, accumulate=True)
    strand_counts.index_put_((p, a, strands.to(torch.int64)), ok, accumulate=True)
    low_qual.index_put_((p,), low.to(torch.int32), accumulate=True)
    total.index_put_((p,), valid.to(torch.int32), accumulate=True)
    return counts, strand_counts, low_qual, total


def init_count_tensors(out_size: int, n_alleles: int = 4, *, device):
    """Zeroed accumulators (counts (W, n, 31), strand counts (W, n, 2),
    low-quality and total (W,)), int32 on `device`."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return (
        z(out_size, n_alleles, N_QBINS),
        z(out_size, n_alleles, 2),
        z(out_size),
        z(out_size),
    )


def accumulate_sorted_calls(
    counts: torch.Tensor,  # (W, n, Q) int32
    strand_counts: torch.Tensor,  # (W, n, 2) int32
    low_qual: torch.Tensor,  # (W,) int32
    total: torch.Tensor,  # (W,) int32
    pos: torch.Tensor,  # (N,) int32 sorted 1-based positions
    attr: torch.Tensor,  # (N,) int32 qual(5b) | allele<<5 | strand<<8
    lo: int,  # first call index
    w0: int,  # window start (1-based)
    count: int,  # calls to scatter
):
    """Scatter calls [lo, lo+count) of the position-sorted call arrays
    (aln_table.device_calls / expand_mrun_calls) into the (W, n, Q) count
    tensors IN PLACE, and return them.

    The JAX version relies on out-of-range scatter updates being dropped:
    an N call (allele 4) and a quality above 30 index past the count
    tensor, vanish from `counts` and still reach `total`/`low_qual`.  Here
    such calls get weight zero at a clamped index."""
    if lo < 0 or count < 0 or lo + count > pos.shape[0]:
        raise ValueError(f"calls [{lo}, {lo + count}) outside the {pos.shape[0]} calls")
    if count == 0:
        return counts, strand_counts, low_qual, total
    out_size, n, nq = counts.shape
    a = attr[lo : lo + count].to(torch.int64)
    rel = pos[lo : lo + count].to(torch.int64) - w0
    valid = (a >= 0) & (rel >= 0) & (rel < out_size)
    q = a & 31
    al = (a >> 5) & 7
    st = (a >> 8) & 1
    low = valid & (q <= MIN_BASE_QS)
    ok_strand = valid & (q > MIN_BASE_QS) & (al < n)
    ok = ok_strand & (q < nq)
    cell = torch.where(valid, rel, 0) * n + torch.clamp(al, max=n - 1)
    counts.view(-1).index_add_(
        0, cell * nq + torch.clamp(q, max=nq - 1), ok.to(torch.int32)
    )
    strand_counts.view(-1).index_add_(0, cell * 2 + st, ok_strand.to(torch.int32))
    p = torch.where(valid, rel, 0)
    low_qual.index_add_(0, p, low.to(torch.int32))
    total.index_add_(0, p, valid.to(torch.int32))
    return counts, strand_counts, low_qual, total


def _logcond_in_order(counts: torch.Tensor, contribution: torch.Tensor) -> torch.Tensor:
    """(P, n, n) float64 log-likelihoods sum_{a,q} counts[p,a,q] *
    C[a,q,i,j], the n * Q terms added one after another in (a, q) order,
    each product and each sum rounded: XLA:CPU's order for the JAX
    package's einsum("paq,aqij->pij"), bit for bit, where a matrix
    product's blocked order differs in the last bits."""
    P, n, nq = counts.shape
    x = counts.reshape(P, n * nq).to(torch.float64)
    m = contribution.reshape(n * nq, n * n)
    acc = torch.zeros((P, n * n), dtype=torch.float64, device=counts.device)
    for k in range(n * nq):
        acc = acc + x[:, k : k + 1] * m[k]
    return acc.reshape(P, n, n)


def genotype_posteriors(
    counts: torch.Tensor,  # (P, n, Q) int32
    contribution: torch.Tensor,  # (n, Q, n, n) float64
    het_rate: float = HET_RATE_DIPLOID,
    n_alleles: int = 4,
):
    """Posterior genotype probabilities of every position of a count
    tensor (ngsepcore_tpu.kernels.genotyping.genotype_posteriors;
    CountsHelper.getPosteriorProbabilities + calculatePosteriorProbabilities,
    CountsHelper.java:410-495).  Returns (post, logcond), both (P, n, n)
    float64; logcond adds its terms in XLA:CPU's order
    (_logcond_in_order)."""
    logcond = _logcond_in_order(counts, contribution)
    return _posteriors(logcond, het_rate, n_alleles), logcond


def genotype_window_from_counts(
    counts: torch.Tensor,  # (W, n, Q) int32
    strand_counts: torch.Tensor,  # (W, n, 2) int32
    total: torch.Tensor,  # (W,) int32
    ref_codes: torch.Tensor,  # (W,) int8
    contribution: torch.Tensor,  # (n, Q, n, n) float64
    het_rate: float,
    min_quality: int,
    n_alleles: int = 4,
) -> dict:
    """Genotype EVERY position of an accumulated count window in float64
    (no screen: the multisample detector reads each sample's call at the
    union of all samples' sites) and compact the interesting sites.

    Returns the per-site rows (site_idx ascending, bi, bj, gq, ref_prob,
    depths, total, logcond, strand_counts; n_sites) and the per-position
    arrays *_full (bi, bj, gq, ref_prob, total, depths).  Every site is
    returned; the JAX version keeps the first 16,384 of a window."""
    P = counts.shape[0]
    n = n_alleles
    logcond = _logcond_in_order(counts, contribution)
    ref_codes = ref_codes.to(torch.int64)
    ref = torch.clamp(ref_codes, 0, n - 1)
    bi, bj, gq, ref_prob = _posterior_decision(logcond, ref, het_rate, n)
    depths = counts.sum(dim=2)
    idx = torch.nonzero(
        _interesting(bi, bj, gq, ref, ref_codes, total, min_quality)
    ).squeeze(1)
    bi = bi.to(torch.int8)
    bj = bj.to(torch.int8)
    return {
        "site_idx": idx.to(torch.int32),
        "n_sites": idx.shape[0],
        "bi": bi[idx],
        "bj": bj[idx],
        "gq": gq[idx],
        "ref_prob": ref_prob[idx],
        "depths": depths[idx],
        "total": total[idx],
        "logcond": logcond[idx],
        "strand_counts": strand_counts[idx],
        "bi_full": bi,
        "bj_full": bj,
        "gq_full": gq,
        "ref_prob_full": ref_prob,
        "total_full": total,
        "depths_full": depths,
    }


# ---- span-scatter genotyper ----------------------------------------------

def _span_scatter_counts(counts128, strand_flat, c, q, ln, pred, cs, ce,
                         strand):
    """Scatter a span of device-path reads into the combined (W, 128)
    counts (cols al*31+q, COL_N for N, COL_LOW for q <= 3; `total` is the
    row sum) and the flat (W*8,) strand counts, in place.

    Reverse reads need no reordering: stored base j of a reverse read maps
    to aligned offset len-1-j with the complemented allele and its own
    quality.  Clip windows are in aligned coordinates."""
    out_size = counts128.shape[0]
    dev = c.device
    Lp = c.shape[1]
    q = torch.clamp(q.to(torch.int64), 0, MAX_BASE_QS)
    c = c.to(torch.int64)
    ln = ln[:, None].to(torch.int64)
    j = torch.arange(Lp, dtype=torch.int64, device=dev)[None, :]
    rev = (strand == 1)[:, None]
    al = torch.where(rev & (c < 4), 3 - c, c)
    off = torch.where(rev, ln - 1 - j, j)
    lo = torch.where(rev, ce[:, None], cs[:, None])
    hi = ln - torch.where(rev, cs[:, None], ce[:, None])
    rel = pred[:, None].to(torch.int64) + off
    valid = (j >= lo) & (j < hi) & (rel >= 0) & (rel < out_size)
    _span_add(counts128, strand_flat, valid, torch.where(valid, rel, 0), q,
              al, strand[:, None].to(torch.int64))


def _span_add(counts128, strand_flat, valid, pos, q, al, st):
    low = q <= MIN_BASE_QS
    col = torch.where(low, COL_LOW, torch.where(al < 4, al * N_QBINS + q, COL_N))
    counts128.view(-1).index_add_(
        0, (pos * N_COLS + col).reshape(-1), valid.to(torch.int32).reshape(-1)
    )
    sidx = pos * 8 + torch.clamp(al, max=3) * 2 + st
    sval = valid & ~low & (al < 4)
    strand_flat.index_add_(0, sidx.reshape(-1), sval.to(torch.int32).reshape(-1))


def _span_packed_scatter(counts128, strand_flat, packed):
    """Host-path packed calls into the combined/flat tensors (packing of
    accumulate_allele_counts_packed), in place."""
    if packed.numel():
        valid, rel, q, al, st = _packed_fields(packed)
        _span_add(counts128, strand_flat, valid, rel, q, al, st)


def genotype_window_span(
    pq: torch.Tensor | None,  # (F, Lp) uint8 packed reads: bits 0-2 base
    # code, bits 3-7 phred quality pre-clamped to 0..30 (None when count=0)
    meta: torch.Tensor | None,  # (F, META_COLS) int64 per-read metadata, rows
    # sorted by predicted start: [pred (concat coords), clip_start,
    # clip_end, strand, length, ...pad]
    start: int,  # first row of this window's span
    count: int,  # rows in the span
    w0: int,  # window start, concatenated coords
    packed: torch.Tensor,  # (N,) int32 packed host-path calls (-1 = skip)
    ref_codes: torch.Tensor,  # (out_size,) int8
    contribution: torch.Tensor,  # (n, Q, n, n) float64
    het_rate: float,
    min_quality: int,
    *,
    out_size: int,
    n_alleles: int = 4,
) -> dict:
    """Window genotyper over a contiguous span of the run-wide fused-read
    arrays (sorted by predicted start, so a window's reads are one row
    range): span scatter + packed host-call scatter + screened
    genotyping.  Same outputs as genotype_window_sparse."""
    dev = ref_codes.device
    counts128 = torch.zeros((out_size, N_COLS), dtype=torch.int32, device=dev)
    strand_flat = torch.zeros(out_size * 8, dtype=torch.int32, device=dev)
    if count:
        sl = pq[start : start + count]
        mt = meta[start : start + count]
        _span_scatter_counts(
            counts128, strand_flat, sl & 7, sl >> 3, mt[:, META_LEN],
            mt[:, META_PRED] - w0, mt[:, META_CS], mt[:, META_CE],
            mt[:, META_STRAND],
        )
    _span_packed_scatter(counts128, strand_flat, packed)
    # every valid call lands in exactly one column: `total` is the row sum,
    # and the slack scales with it
    total = counts128.sum(dim=1, dtype=torch.int32)
    return _screened_sites(
        counts128, strand_flat.view(-1, 8), total, total, ref_codes,
        contribution, het_rate, min_quality, n_alleles,
    )


# ---- shear-histogram genotyper --------------------------------------------

def genotype_window_hist(
    stage_t: torch.Tensor,  # (Lp, S) uint8 transposed col-byte stage
    w0s: int,  # stage col of window position 0
    colg: torch.Tensor,  # (Fall, Lp) uint8 genome-oriented col bytes (all reads)
    res_idx: torch.Tensor,  # (Rr,) int64 residual rows into colg
    res_pred: torch.Tensor,  # (Rr,) int32 residual start rel. to window
    packed: torch.Tensor,  # (N,) int32 packed host-path calls (-1 = skip)
    ref_codes: torch.Tensor,  # (window,) int8
    contribution: torch.Tensor,  # (4, Q, 4, 4) float64 (full 31-bin table)
    expand: torch.Tensor,  # (128, 128) float64 0/1: binned cols -> dense 124-col
    cdb32: torch.Tensor,  # (128, 16) float32 screen table rows per BINNED col
    qual_bin: torch.Tensor,  # (31,) int64 quality -> bin
    het_rate: float,
    min_quality: int,
    *,
    window: int,
    nq: int,
    lanes: int,
    n_alleles: int = 4,
) -> dict:
    """Window genotyper over the scatter-free shear-histogram pileup.

    Stage 1 screens every position in float32 (binned columns @ cdb32);
    stage 2 expands the flagged positions' binned counts back to the dense
    (allele x 31-qual) columns with an exact 0/1 product and contracts
    them with the float64 table.  Returns device tensors, one row per
    interesting site: site_idx, bi, bj, gq, ref_prob, depths, total,
    logcond, strand_counts; plus n_sites and n_flagged."""
    _require_full_f32(stage_t)
    n = n_alleles
    ncnt = 4 * nq + 2
    hist = shear_hist(stage_t, w0s, window=window, nq=nq, lanes=lanes)
    if res_idx.numel():
        hist_residual_scatter(hist, colg[res_idx], res_pred, nq)
    if packed.numel():
        hist_packed_scatter(hist, packed, qual_bin, nq, MIN_BASE_QS)

    ref_codes = ref_codes.to(torch.int64)
    ref = torch.clamp(ref_codes, 0, n - 1)
    total = hist[:, :ncnt].sum(dim=1, dtype=torch.int32)
    # stage 1 on the binned columns; stage 2 expands the flagged rows back
    # to the dense (allele x 31-qual) columns with an exact 0/1 product
    flag = _screen_flag(hist.to(torch.float32) @ cdb32, ref, total, total,
                        het_rate, n)
    fidx = torch.nonzero(flag).squeeze(1)  # ascending
    csub_b = hist[fidx]  # (F, 128) binned layout
    csub = csub_b.to(torch.float64) @ expand  # exact: counts < 2^53, 0/1
    sidx, bi, bj, gq, ref_prob, logcond = _exact_sites(
        csub, _dense_table(contribution, n, N_COLS), ref[fidx],
        ref_codes[fidx], total[fidx], het_rate, min_quality, n,
    )
    gsel = fidx[sidx]
    return {
        "site_idx": gsel.to(torch.int32),
        "n_sites": sidx.shape[0],
        "n_flagged": fidx.shape[0],
        "bi": bi,
        "bj": bj,
        "gq": gq,
        "ref_prob": ref_prob,
        "depths": csub[sidx][:, : n * N_QBINS].reshape(-1, n, N_QBINS).sum(dim=2),
        "total": total[gsel],
        "logcond": logcond,
        "strand_counts": csub_b[sidx][:, STRAND_COL0:].reshape(-1, n, 2),
    }


def hist_tables(
    nq: int,
    qual_levels: np.ndarray,
    contribution: np.ndarray | None = None,
    n_alleles: int = 4,
):
    """(expand, cdb32, qual_bin) numpy tables for genotype_window_hist.

    qual_levels: sorted distinct clamped base qualities present in the run
    (length nq).  expand maps binned columns to the dense al*31+q layout;
    cdb32 is the float32 screen table with one row per binned column
    (strand and unused columns zero) built from the SAME contribution
    table the exact stage uses; qual_bin maps a clamped quality 0..30 to
    its bin (absent qualities map to bin 0 — they never occur in data)."""
    n = n_alleles
    C = (
        np.asarray(contribution)
        if contribution is not None
        else snv_contribution_table(n)
    )
    G = n * n
    expand = np.zeros((128, 128), np.float32)
    cdb32 = np.zeros((128, G), np.float32)
    qual_bin = np.zeros(31, np.int32)
    for b, q in enumerate(qual_levels):
        qual_bin[int(q)] = b
        for a in range(n):
            expand[a * nq + b, a * N_QBINS + int(q)] = 1.0
            cdb32[a * nq + b] = C[a, int(q)].reshape(G).astype(np.float32)
    return expand, cdb32, qual_bin


def genotype_window_hist_resolve_batch(pending: list[dict]) -> list[dict]:
    """Fetch window genotyper results (any of the three) to host numpy,
    one dict per window.  All sites are exact already (dynamic shapes), so
    resolving is only the device->host copy."""
    return [
        {
            k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in res.items()
        }
        for res in pending
    ]


def place_fused_rows(
    pq_out: torch.Tensor,  # (F_pad, Lp) uint8 compacted packed reads (in place)
    pq_batch: torch.Tensor,  # (B, Lpb) uint8 one aligner batch
    src: torch.Tensor,  # (Rb,) int64 fused row indices within the batch
    dst: torch.Tensor,  # (Rb,) int64 destination rows
) -> torch.Tensor:
    """Scatter one batch's fused rows into the run-wide compacted read
    array, reusing the batch matrix uploaded for seeding."""
    rows = pq_batch[src]
    Lp_out = pq_out.shape[1]
    rows = rows[:, :Lp_out]
    pq_out[dst, : rows.shape[1]] = rows
    return pq_out
