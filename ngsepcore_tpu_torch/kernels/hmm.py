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
  sample, or `posterior_log_batch_ref`.
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
# a block's threads, as many samples as fill them (one at S > 256): 4 at S 64,
# the fastest of 1-8 at the imputer's n 300 x T 5,000 and within 8% of the
# fastest at n 32-1,200 (fb_bench.py, PERF.md)
FB_BLOCK_THREADS = 256


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


def posterior_log_batch(log_start, log_trans, log_emit):
    """State posteriors of n sequences of T steps that share the model:
    log_start (S,), log_trans (1, S, S) shared by every step or (T-1, S, S),
    log_emit (n, T, S).  Returns (posteriors (n, T, S) in log10, the
    log-likelihoods (n,)), what jax.vmap(posterior_log, (None, None, 0))
    returns.  S <= MAX_FB_STATES.  CPU tensors run posterior_log_batch_ref;
    CUDA tensors launch csrc/forward_backward.cu once for every sequence,
    as many sequences a block as fill FB_BLOCK_THREADS threads."""
    per_step = _check_fb_args(log_start, log_trans, log_emit)
    n, T, S = log_emit.shape
    if S > MAX_FB_STATES:  # on either device, so that CPU and CUDA runs agree
        raise ValueError(
            f"{S} states: the forward-backward kernel takes at most {MAX_FB_STATES} "
            "(k <= 32 haplotype clusters)")
    dev = log_emit.device
    if dev.type == "cpu":
        return posterior_log_batch_ref(log_start, log_trans, log_emit)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    samples_per_block = max(1, FB_BLOCK_THREADS // ((S + 31) // 32 * 32))
    log_start = log_start.contiguous()
    log_trans = log_trans.contiguous()
    log_emit = log_emit.contiguous()
    post = torch.empty_like(log_emit)  # contiguous, as the kernel writes it
    ll = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return post, ll
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.forward_backward_launch(
            log_start.data_ptr(), log_trans.data_ptr(), log_emit.data_ptr(), n, T, S,
            int(per_step), samples_per_block, post.data_ptr(), ll.data_ptr(), stream,
        )
    check("posterior_log_batch", rc)
    posterior_log_batch.launches += 1
    return post, ll


posterior_log_batch.launches = 0


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
