"""Log-space HMM forward/backward/posterior/Viterbi on float64 tensors.

Ref: src/ngsep/hmm/HMM.java:24-110 (interface), AbstractHMM.java:29-277
(log10-space forward/backward/posterior decoding/Viterbi, Baum-Welch
constants).  Counterpart of ngsepcore_tpu/kernels/hmm.py, whose recursions
are lax.scan loops; here each is a step loop of vectorized (states,)
updates on the device of its inputs.

All probabilities are log10 like the reference (LogMath conventions).
Emissions are supplied as a dense (T, S) log-emission matrix — the
per-model emission logic (Poisson read depth, imputation haplotype
clusters) builds that matrix and reuses these functions.  Transitions are
(1, S, S), shared by every step, or (T-1, S, S).

Two recursions carry ported main paths, each a hand-written kernel on a
CUDA tensor and a plain step loop on a CPU tensor:
- `viterbi_log` (the read-depth HMM callers, ~46,000 steps a sequence):
  csrc/viterbi.cu, or `viterbi_log_ref`.  `viterbi_log_batch` decodes every
  sequence of a call (concatenated, ragged) in one launch, which is how the
  callers use it.
- `posterior_log_batch` (the imputer's E-step: n samples of one window,
  S = k^2 product states, per-step transitions): csrc/forward_backward.cu,
  one launch for forward, backward, posteriors and log-likelihoods of every
  sample, or `posterior_log_batch_ref`.  The kernel has two forms: the
  product form (scaled linear probabilities, a step one f64 product on the
  tensor cores) for inputs whose values stay in range (`fb_form`), the log
  form for any other.
forward_log, backward_log, posterior_log and baum_welch_expected_counts
(one sequence) are plain step loops on either device.
"""
from __future__ import annotations

import torch

from .cuda_build import check, library

NEG_INF = -1e30
MAX_STATES = 32  # one warp lane a state (csrc/viterbi.cu)
# one thread a state, a block at most 1,024 threads (csrc/forward_backward.cu):
# k <= 32 haplotype clusters in the imputer
MAX_FB_STATES = 1024
# the log form: a block's threads, as many samples as fill them (one at S >
# 256): 4 at S 64, the fastest of 1-8 at the imputer's n 300 x T 5,000 and
# within 8% of the fastest at n 32-1,200 (fb_bench.py, PERF.md)
FB_BLOCK_THREADS = 256
# the product form: S <= 64 (a step's matrix in each stage of a shared-memory
# ring) and 2 max(R_M, R_S) + 3 R_E <= PRODUCT_RANGE decades (R_M: the largest
# spread of one step's transitions, R_S: the start's, R_E: the largest of one
# sample-step's emissions), which keeps every scaled value a normal f64: the
# derivation is in csrc/forward_backward.cu
PRODUCT_MAX_STATES = 64
PRODUCT_RANGE = 250.0
# the product form's samples a block (8 or 16); None: 8 where the blocks fit
# the SMs, else 16
FB_PRODUCT_ROWS = None
FB_FORMS = ("product", "log")


def _log10sumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    # the JAX package's arithmetic (hmm.py:23-29), not torch.logsumexp, so
    # results stay within rounding of it
    m = torch.amax(x, dim=dim, keepdim=True)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    s = torch.sum(torch.pow(10.0, x - m_safe), dim=dim, keepdim=True)
    out = torch.where(finite, m_safe + torch.log10(s), m)
    return out.squeeze(dim)


def _check_hmm_args(log_start, log_trans, log_emit):
    """Shapes, dtype and device of (start, trans, emit); True when the
    transitions differ per step."""
    for name, t in (("log_start", log_start), ("log_trans", log_trans),
                    ("log_emit", log_emit)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float64:
            raise TypeError(f"{name} must be a float64 tensor")
        if t.device != log_emit.device:
            raise ValueError("log_start, log_trans and log_emit must share a device")
    if log_emit.dim() != 2 or log_emit.shape[0] < 1 or log_emit.shape[1] < 1:
        raise ValueError("log_emit must be (T, S) with T >= 1 and S >= 1")
    T, S = log_emit.shape
    if log_start.shape != (S,):
        raise ValueError(f"log_start must be ({S},)")
    if log_trans.dim() != 3 or log_trans.shape[1:] != (S, S) or (
        log_trans.shape[0] not in (1, T - 1)
    ):
        raise ValueError(f"log_trans must be (1, {S}, {S}) or ({T - 1}, {S}, {S})")
    return log_trans.shape[0] != 1


def forward_log(log_start, log_trans, log_emit):
    """Forward recursion; returns (log_alpha (T,S), log_likelihood)."""
    per_step = _check_hmm_args(log_start, log_trans, log_emit)
    T = log_emit.shape[0]
    log_alpha = torch.empty_like(log_emit)
    alpha = log_start + log_emit[0]
    log_alpha[0] = alpha
    for t in range(1, T):
        trans_t = log_trans[t - 1 if per_step else 0]
        alpha = _log10sumexp(alpha[:, None] + trans_t, 0) + log_emit[t]
        log_alpha[t] = alpha
    return log_alpha, _log10sumexp(log_alpha[-1], 0)


def backward_log(log_trans, log_emit):
    """Backward recursion; returns log_beta (T,S)."""
    T, S = log_emit.shape
    per_step = _check_hmm_args(log_emit.new_zeros(S), log_trans, log_emit)
    log_beta = torch.empty_like(log_emit)
    beta = log_emit.new_zeros(S)
    log_beta[T - 1] = beta
    for t in range(T - 2, -1, -1):
        trans_t = log_trans[t if per_step else 0]
        beta = _log10sumexp(trans_t + (log_emit[t + 1] + beta)[None, :], 1)
        log_beta[t] = beta
    return log_beta


def posterior_log(log_start, log_trans, log_emit):
    """State posteriors per position: returns (posteriors (T,S) in log10,
    log-likelihood)."""
    log_alpha, ll = forward_log(log_start, log_trans, log_emit)
    un = log_alpha + backward_log(log_trans, log_emit)
    return un - _log10sumexp(un, 1)[:, None], ll


def _check_fb_args(log_start, log_trans, log_emit):
    """Shapes, dtype and device of a batch of equal-length sequences
    (start (S,), trans (1|T-1, S, S), emit (n, T, S)); True when the
    transitions differ per step."""
    for name, t in (("log_start", log_start), ("log_trans", log_trans),
                    ("log_emit", log_emit)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float64:
            raise TypeError(f"{name} must be a float64 tensor")
        if t.device != log_emit.device:
            raise ValueError("log_start, log_trans and log_emit must share a device")
    if log_emit.dim() != 3 or log_emit.shape[1] < 1 or log_emit.shape[2] < 1:
        raise ValueError("log_emit must be (n, T, S) with T >= 1 and S >= 1")
    _, T, S = log_emit.shape
    if log_start.shape != (S,):
        raise ValueError(f"log_start must be ({S},)")
    if log_trans.dim() != 3 or log_trans.shape[1:] != (S, S) or (
        log_trans.shape[0] not in (1, T - 1)
    ):
        raise ValueError(f"log_trans must be (1, {S}, {S}) or ({T - 1}, {S}, {S})")
    return log_trans.shape[0] != 1


def posterior_log_batch_ref(log_start, log_trans, log_emit):
    """Plain batched step loop of posterior_log_batch on the tensors'
    device: every step updates the (n, S) values of all sequences at once."""
    per_step = _check_fb_args(log_start, log_trans, log_emit)
    T = log_emit.shape[1]
    log_alpha = torch.empty_like(log_emit)
    alpha = log_start + log_emit[:, 0]
    log_alpha[:, 0] = alpha
    for t in range(1, T):
        trans_t = log_trans[t - 1 if per_step else 0]
        alpha = _log10sumexp(alpha[:, :, None] + trans_t, 1) + log_emit[:, t]
        log_alpha[:, t] = alpha
    ll = _log10sumexp(log_alpha[:, -1], 1)
    log_beta = torch.empty_like(log_emit)
    beta = torch.zeros_like(log_emit[:, 0])
    log_beta[:, T - 1] = beta
    for t in range(T - 2, -1, -1):
        trans_t = log_trans[t if per_step else 0]
        beta = _log10sumexp(trans_t + (log_emit[:, t + 1] + beta)[:, None, :], 2)
        log_beta[:, t] = beta
    un = log_alpha + log_beta
    return un - _log10sumexp(un, 2)[..., None], ll


def _spread(x: torch.Tensor, lead: int) -> torch.Tensor:
    """max - min over all but the first `lead` dims, +inf where an entry
    is not finite."""
    x = x.flatten(lead)
    bad = (~torch.isfinite(x)).any(dim=-1)
    return torch.where(bad, torch.inf, x.amax(dim=-1) - x.amin(dim=-1))


def range_stats_ref(log_start, log_trans, log_emit) -> tuple:
    """(R_M, R_E, R_S) of the product form's route on the tensors' device:
    the largest spread (max - min) of one step's transitions, of one
    sample-step's emissions, and the start's; +inf where an entry is not
    finite.  csrc/forward_backward.cu's fb_prepare_kernel computes the
    same numbers (maxima, minima and one subtraction are exact in any
    order)."""
    def most(x):
        return float(x.max()) if x.numel() else 0.0

    return (most(_spread(log_trans, 1)), most(_spread(log_emit, 2)),
            most(_spread(log_start, 0)))


def product_form_ok(S: int, stats) -> bool:
    """The product form's precondition from range_stats_ref's numbers."""
    rm, re, rs = stats
    return S <= PRODUCT_MAX_STATES and 2 * max(rm, rs) + 3 * re <= PRODUCT_RANGE


def fb_form(log_start, log_trans, log_emit) -> str:
    """The form posterior_log_batch takes for these inputs, on either
    device: "product" where product_form_ok holds, else "log".  On a CUDA
    tensor this runs the product form's prologue kernel and reads its three
    numbers."""
    _check_fb_args(log_start, log_trans, log_emit)
    S = log_emit.shape[2]
    if S > PRODUCT_MAX_STATES or log_emit.shape[0] == 0:
        return "log"
    if log_emit.device.type == "cuda":
        stats = _read_stats(_fb_prepare(library(), log_start, log_trans, log_emit))
    else:
        stats = range_stats_ref(log_start, log_trans, log_emit)
    return "product" if product_form_ok(S, stats) else "log"


def _read_stats(prepared) -> list:
    """(R_M, R_E, R_S) of _fb_prepare's result, read from the card."""
    return prepared[3].cpu().view(torch.float64).tolist()


def _fb_prepare(lib, log_start, log_trans, log_emit):
    """The product form's prologue (fb_prepare_launch) on the inputs'
    device, contiguous inputs: (P in the kernel's fragment order (steps, 2,
    Sp, Sp), gmax (steps,), the scaled emissions E^ (n, T, S), the three
    spreads as a (3,) int64 tensor of f64 bits)."""
    n, T, S = log_emit.shape
    dev = log_emit.device
    Sp = (S + 7) // 8 * 8
    nM = log_trans.shape[0]
    P = torch.empty((nM, 2, Sp, Sp), dtype=torch.float64, device=dev)
    gmax = torch.empty(nM, dtype=torch.float64, device=dev)
    Eh = torch.empty_like(log_emit)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fb_prepare_launch(
            log_start.data_ptr(), log_trans.data_ptr(), log_emit.data_ptr(), n, T, S, nM,
            P.data_ptr(), gmax.data_ptr(), Eh.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check("fb_prepare", rc)
    return P, gmax, Eh, stats


def product_tiles(n: int, dev) -> int:
    """m8 tiles a block of the product form: FB_PRODUCT_ROWS / 8, else one
    where its blocks fit the SMs, two beyond."""
    if FB_PRODUCT_ROWS is not None:
        return FB_PRODUCT_ROWS // 8
    return 1 if -(-n // 8) <= torch.cuda.get_device_properties(dev).multi_processor_count else 2


def _fb_product(lib, log_start, prepared, log_emit, per_step: bool, mt: int):
    """One launch of the product form (fb_product_launch: the recursions,
    then the posterior pass) on _fb_prepare's `prepared`: (post, ll)."""
    P, gmax, Eh = prepared[:3]
    n, T, S = log_emit.shape
    dev = log_emit.device
    post = torch.empty_like(log_emit)
    ll = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fb_product_launch(
            log_start.data_ptr(), P.data_ptr(), gmax.data_ptr(), Eh.data_ptr(),
            log_emit.data_ptr(), n, T, S, int(per_step), mt, post.data_ptr(), ll.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check("posterior_log_batch", rc)
    return post, ll


def _fb_log(lib, log_start, log_trans, log_emit, per_step: bool, samples_per_block: int):
    """One launch of the log form (forward_backward_launch): (post, ll)."""
    n, T, S = log_emit.shape
    dev = log_emit.device
    post = torch.empty_like(log_emit)
    ll = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.forward_backward_launch(
            log_start.data_ptr(), log_trans.data_ptr(), log_emit.data_ptr(), n, T, S,
            int(per_step), samples_per_block, post.data_ptr(), ll.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check("posterior_log_batch", rc)
    return post, ll


def posterior_log_batch(log_start, log_trans, log_emit, form=None):
    """State posteriors of n sequences of T steps that share the model:
    log_start (S,), log_trans (1, S, S) shared by every step or (T-1, S, S),
    log_emit (n, T, S).  Returns (posteriors (n, T, S) in log10, the
    log-likelihoods (n,)), what jax.vmap(posterior_log, (None, None, 0))
    returns.  S <= MAX_FB_STATES.  CPU tensors run posterior_log_batch_ref;
    CUDA tensors launch csrc/forward_backward.cu once for every sequence, in
    the form `form` names: "product" (S <= PRODUCT_MAX_STATES and the range
    of product_form_ok: a ValueError on either device where the input does
    not meet it), "log" (any input), or None: the product form where the
    input meets its precondition (fb_form), else the log form.  Checking
    the precondition reads three numbers from the card; under CUDA graph
    capture no read can run, so a capture names the form, and "product" is
    then taken on the caller's word.  `launches` counts the launches,
    `launches_by_form` them by form."""
    per_step = _check_fb_args(log_start, log_trans, log_emit)
    n, T, S = log_emit.shape
    if S > MAX_FB_STATES:  # on either device, so that CPU and CUDA runs agree
        raise ValueError(
            f"{S} states: the forward-backward kernel takes at most {MAX_FB_STATES} "
            "(k <= 32 haplotype clusters)")
    if form not in (None, *FB_FORMS):
        raise ValueError(f"form must be one of {FB_FORMS} or None, not {form!r}")
    if form == "product" and S > PRODUCT_MAX_STATES:
        raise ValueError(f"{S} states: the product form takes at most {PRODUCT_MAX_STATES}")
    dev = log_emit.device
    if dev.type == "cpu":
        if form == "product" and n and not product_form_ok(
                S, range_stats_ref(log_start, log_trans, log_emit)):
            raise ValueError("the input is out of the product form's range (product_form_ok)")
        return posterior_log_batch_ref(log_start, log_trans, log_emit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    log_start = log_start.contiguous()
    log_trans = log_trans.contiguous()
    log_emit = log_emit.contiguous()
    if n == 0:
        return torch.empty_like(log_emit), torch.empty(0, dtype=torch.float64, device=dev)
    lib = library()
    chosen = "log" if form == "log" or S > PRODUCT_MAX_STATES else "product"
    if chosen == "product":
        prepared = _fb_prepare(lib, log_start, log_trans, log_emit)
        if torch.cuda.is_current_stream_capturing():
            if form is None:
                raise ValueError("name the form under CUDA graph capture: the route reads "
                                 "the card")
        elif not product_form_ok(S, _read_stats(prepared)):
            if form == "product":
                raise ValueError("the input is out of the product form's range "
                                 "(product_form_ok)")
            chosen = "log"
    if chosen == "product":
        post, ll = _fb_product(lib, log_start, prepared, log_emit, per_step,
                               product_tiles(n, dev))
    else:
        samples_per_block = max(1, FB_BLOCK_THREADS // ((S + 31) // 32 * 32))
        post, ll = _fb_log(lib, log_start, log_trans, log_emit, per_step, samples_per_block)
    posterior_log_batch.launches += 1
    posterior_log_batch.launches_by_form[chosen] += 1
    return post, ll


posterior_log_batch.launches = 0
posterior_log_batch.launches_by_form = dict.fromkeys(FB_FORMS, 0)


def viterbi_log_ref(log_start, log_trans, log_emit):
    """Plain step loop of viterbi_log on the tensors' device: the first
    maximum wins a tie, at every step and at the end (torch.max's rule,
    and jnp.argmax's).  A step's maximum orders -0.0 below +0.0, as the
    JAX package's jnp.max does, so that a best score of zero has its sign."""
    per_step = _check_hmm_args(log_start, log_trans, log_emit)
    T, S = log_emit.shape
    delta = log_start + log_emit[0]
    back = torch.empty((T - 1, S), dtype=torch.int64, device=log_emit.device)
    for t in range(1, T):
        trans_t = log_trans[t - 1 if per_step else 0]
        scores = delta[:, None] + trans_t
        top, back[t - 1] = torch.max(scores, dim=0)
        # where a score is +0.0 the maximum is >= +0.0: adding +0.0 turns a
        # -0.0 maximum into +0.0 and leaves any other as it is
        pos_zero = (scores.view(torch.int64) == 0).any(dim=0)
        delta = torch.where(pos_zero, top + 0.0, top) + log_emit[t]
    last = torch.argmax(delta)
    best = delta[last]
    # the backtrace is T dependent one-element reads: walk it on the host
    back = back.cpu().numpy()
    path = [int(last)]
    for t in range(T - 2, -1, -1):
        path.append(int(back[t, path[-1]]))
    path = torch.tensor(path[::-1], dtype=torch.int32, device=log_emit.device)
    return path, best


def ragged_layout(lengths, S: int) -> torch.Tensor:
    """csrc/viterbi.cu's offsets of a batch of sequences of `lengths` steps
    and S states: a (2, n+1) int64 CPU tensor whose row 0 holds the first
    row of each sequence in the concatenated emissions (and paths) and row 1
    its first back-pointer word (ceil((T-1)/8) x S 64-bit words a sequence,
    one byte a step and state); column n holds the totals."""
    rows, words = [0], [0]
    for T in lengths:
        T = int(T)
        if T < 1:
            raise ValueError("every sequence needs T >= 1")
        rows.append(rows[-1] + T)
        words.append(words[-1] + (T + 6) // 8 * S)
    return torch.tensor([rows, words], dtype=torch.int64)


def _check_batch_args(log_start, log_trans, log_emits, lengths):
    """Shapes, dtype and device of a batch; True when the transitions differ
    per step (a batch of one only)."""
    for name, t in (("log_start", log_start), ("log_trans", log_trans),
                    ("log_emits", log_emits)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float64:
            raise TypeError(f"{name} must be a float64 tensor")
        if t.device != log_emits.device:
            raise ValueError("log_start, log_trans and log_emits must share a device")
    n = len(lengths)
    if log_emits.dim() != 2 or log_emits.shape[1] < 1:
        raise ValueError("log_emits must be (sum T, S) with S >= 1")
    S = log_emits.shape[1]
    if sum(int(T) for T in lengths) != log_emits.shape[0] or min(lengths, default=1) < 1:
        raise ValueError("lengths must be >= 1 and sum to the rows of log_emits")
    if log_start.shape != (n, S):
        raise ValueError(f"log_start must be ({n}, {S})")
    per_step = n == 1 and log_trans.dim() == 3 and log_trans.shape[0] != 1
    steps = int(lengths[0]) - 1 if per_step else n
    if log_trans.shape != (steps, S, S):
        raise ValueError(f"log_trans must be ({n}, {S}, {S})"
                         + (f" or ({steps}, {S}, {S})" if n == 1 else ""))
    return per_step


def viterbi_log_batch(log_start, log_trans, log_emits, lengths):
    """Most likely state paths of n sequences in one call: log_start (n, S),
    log_trans (n, S, S), one matrix a sequence shared by its steps (or, for
    n = 1, (T-1, S, S) per step), log_emits (sum T, S) the sequences'
    emissions concatenated, lengths their T.  Returns (paths (sum T,) int32
    concatenated the same way, best (n,) f64).  CPU tensors run
    viterbi_log_ref on each sequence; CUDA tensors launch csrc/viterbi.cu
    once for the whole batch."""
    lengths = [int(T) for T in lengths]
    per_step = _check_batch_args(log_start, log_trans, log_emits, lengths)
    n, S = len(lengths), log_emits.shape[1]
    dev = log_emits.device
    if dev.type == "cpu":
        paths, bests, r0 = [], [], 0
        for b, T in enumerate(lengths):
            trans = log_trans if per_step else log_trans[b : b + 1]
            path, best = viterbi_log_ref(log_start[b], trans, log_emits[r0 : r0 + T])
            paths.append(path)
            bests.append(best)
            r0 += T
        return (torch.cat(paths) if paths else torch.empty(0, dtype=torch.int32),
                torch.stack(bests) if bests else torch.empty(0, dtype=torch.float64))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if S > MAX_STATES:
        raise ValueError(f"{S} states: the Viterbi kernel takes at most {MAX_STATES}")
    layout = ragged_layout(lengths, S)
    # pinned, so that the copy does not wait for the stream's earlier work
    offsets = layout.pin_memory().to(dev, non_blocking=True)
    back = torch.empty(int(layout[1, -1]), dtype=torch.int64, device=dev)
    path = torch.empty(int(layout[0, -1]), dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return path, best
    log_start = log_start.contiguous()
    log_trans = log_trans.contiguous()
    log_emits = log_emits.contiguous()
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.viterbi_launch(
            log_start.data_ptr(), log_trans.data_ptr(), log_emits.data_ptr(),
            offsets.data_ptr(), n, S, int(per_step), back.data_ptr(), path.data_ptr(),
            best.data_ptr(), stream,
        )
    check("viterbi_log", rc)
    viterbi_log.launches += 1
    return path, best


def viterbi_log(log_start, log_trans, log_emit):
    """Most likely state path; returns (path (T,) int32, best log prob).
    CPU tensors run viterbi_log_ref; CUDA tensors launch the kernel, as
    viterbi_log_batch of one sequence.  `launches` counts every launch of
    the kernel, this function's and viterbi_log_batch's.

    Ref: AbstractHMM.getViterbiPath.
    """
    if log_emit.device.type == "cpu":
        return viterbi_log_ref(log_start, log_trans, log_emit)
    if log_emit.device.type != "cuda":
        raise ValueError(f"unsupported device {log_emit.device}")
    _check_hmm_args(log_start, log_trans, log_emit)
    path, best = viterbi_log_batch(log_start[None], log_trans, log_emit, [log_emit.shape[0]])
    return path, best[0]


viterbi_log.launches = 0


def baum_welch_expected_counts(log_start, log_trans, log_emit):
    """E-step statistics: expected transition counts (S,S) and per-position
    state posteriors (T,S), both in linear space, and the log-likelihood.

    Ref: AbstractHMM Baum-Welch accumulation (calculateForward/Backward +
    expected transitions).
    """
    log_alpha, ll = forward_log(log_start, log_trans, log_emit)
    log_beta = backward_log(log_trans, log_emit)
    # xi[t,i,j] = alpha[t,i] + trans[t,i,j] + emit[t+1,j] + beta[t+1,j] - ll
    xi = (
        log_alpha[:-1, :, None]
        + log_trans
        + (log_emit[1:] + log_beta[1:])[:, None, :]
        - ll
    )
    expected_trans = torch.sum(torch.pow(10.0, xi), dim=0)
    return expected_trans, torch.pow(10.0, log_alpha + log_beta - ll), ll
