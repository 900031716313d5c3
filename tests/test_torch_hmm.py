"""ngsepcore_tpu_torch.kernels.hmm against ngsepcore_tpu.kernels.hmm on the
CPU, on seeded numpy inputs: Viterbi path and best score equal (ties and
-inf transitions included), forward/backward/posterior within 1e-10
absolute in log10, Baum-Welch expected counts within 1e-10 relative in
linear space, posterior_log_batch within 1e-10 of jax.vmap(posterior_log)
and torch models of csrc/forward_backward.cu's two forms (the log form's
summation order; the product form's scaling, products and assembly) within
1e-12 of its plain loop, with the product form's route by its precondition.  A torch model of csrc/viterbi.cu's lane decomposition is
held against the plain step loop bit for bit, and viterbi_log_batch's CPU
path (ragged batches) against the loop and the JAX package; best scores
are compared by bit pattern, the sign of a zero included."""
import math

import numpy as np
import pytest
import torch

import ngsepcore_tpu.kernels.hmm as jhmm
import ngsepcore_tpu_torch.kernels.hmm as thmm

torch.set_num_threads(1)

T_ = torch.from_numpy


def _hmm(seed, T, S, per_step=False, neg_inf=False):
    """Random log10 HMM: start (S,), trans (1|T-1, S, S), emit (T, S)."""
    rng = np.random.default_rng(seed)
    start = np.log10(rng.dirichlet(np.ones(S)))
    n_trans = max(T - 1, 0) if per_step else 1
    trans = rng.dirichlet(np.ones(S), size=(n_trans, S))
    if neg_inf:
        # forbid some transitions outright; every row keeps its diagonal
        forbid = rng.random((n_trans, S, S)) < 0.3
        forbid[:, np.arange(S), np.arange(S)] = False
        trans = np.where(forbid, 0.0, trans)
    with np.errstate(divide="ignore"):
        trans = np.log10(trans)
    emit = np.log10(rng.random((T, S)))
    return start, trans, emit


def _tie_hmm(T=40, S=4):
    """Every path scores the same: integers, so sums are exact and every
    argmax is a tie that the first index must win."""
    return np.zeros(S), np.zeros((1, S, S)), -np.ones((T, S))


def _signed_zero_hmm(seed, T=40, S=5):
    """Start -0.0, transitions +-0.0 at random, emissions -0.0 with a few
    +0.0: every candidate ties, and a best score's sign is that of a
    maximum that orders -0.0 below +0.0 (the JAX package's jnp.max).  At
    seed 3 the first maximum's sum is -0.0 where that maximum is +0.0."""
    rng = np.random.default_rng(seed)
    start = np.full(S, -0.0)
    trans = np.where(rng.random((1, S, S)) < 0.5, -0.0, 0.0)
    emit = np.where(rng.random((T, S)) < 0.03, 0.0, -0.0)
    return start, trans, emit


def _bits(x):
    return np.float64(float(x)).view(np.int64)


CASES = {
    "shared_S5": dict(seed=1, T=257, S=5),
    "per_step_S5": dict(seed=2, T=64, S=5, per_step=True),
    "neg_inf_shared": dict(seed=3, T=120, S=6, neg_inf=True),
    "neg_inf_per_step": dict(seed=4, T=50, S=3, per_step=True, neg_inf=True),
    "S32": dict(seed=5, T=33, S=32),
    "T1": dict(seed=6, T=1, S=5),
    "T2": dict(seed=7, T=2, S=5, per_step=True),
    "S1": dict(seed=8, T=9, S=1),
}


def _case(name):
    if name == "tie":
        return _tie_hmm()
    if name == "signed_zero":
        return _signed_zero_hmm(3)
    if name == "signed_zero_then_random":
        # zeros tie through the first staged chunks, random sums after
        start, trans, emit = _signed_zero_hmm(3, T=600)
        emit[300:] = np.log10(np.random.default_rng(3).random((300, emit.shape[1])))
        return start, trans, emit
    return _hmm(**CASES[name])


ALL = sorted(CASES) + ["tie", "signed_zero", "signed_zero_then_random"]


@pytest.mark.parametrize("name", ALL)
def test_viterbi_equals_jax(name):
    start, trans, emit = _case(name)
    want_path, want_best = jhmm.viterbi_log(start, trans, emit)
    path, best = thmm.viterbi_log(T_(start), T_(trans), T_(emit))
    assert path.dtype == torch.int32 and path.shape == (emit.shape[0],)
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    assert _bits(best) == _bits(want_best)
    if name == "tie":
        assert not path.any()


@pytest.mark.parametrize("seed", range(6))
def test_signed_zero_best_equals_jax(seed):
    """Where every candidate is a zero (or a small integer, so that sums
    are exact and zeros of either sign arise), path and best score equal
    the JAX package's by bit pattern, for plain loop and kernel model."""
    rng = np.random.default_rng(seed)
    S, T = int(rng.integers(2, 9)), int(rng.integers(2, 60))
    if seed % 2:
        start, trans, emit = _signed_zero_hmm(seed, T, S)
    else:
        vals = np.array([-2.0, -1.0, -0.0, 0.0, 1.0])
        start, trans, emit = (rng.choice(vals, shape) for shape in ((S,), (1, S, S), (T, S)))
    want_path, want_best = jhmm.viterbi_log(start, trans, emit)
    for path, best in (thmm.viterbi_log(T_(start), T_(trans), T_(emit)),
                       _kernel_model(T_(start), T_(trans), T_(emit))):
        np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
        assert _bits(best) == _bits(want_best)


def _ring_steps(cap, per_step):
    """Ring<kCap, kPerStep>::kSteps of csrc/viterbi.cu."""
    return (32 if cap <= 8 else 8) if per_step else (256 if cap <= 8 else 64)


def _kernel_model(start, trans, emit):
    """viterbi_kernel of csrc/viterbi.cu, statement by statement with the
    lanes as a tensor axis.  kCap is S exactly for shared transitions and
    S <= 8, else a padded 8 or 32 (candidates from S up are the last
    state's delta, which the idle lanes mirror, plus -inf).  Steps are
    taken a staged chunk of _ring_steps at a time; lane j exchanges every
    delta, adds its transition column, takes the value and index of the
    first maximum by a tree of compare-selects in which the left range
    keeps a tie (first_max, the index carried beside the value), and adds
    z + the emission, z the zero whose sign bit is the AND of the
    candidates' (jnp.max's sign).  A block of 8 back pointers is packed
    into the bytes of one 64-bit word.  The last deltas are folded with a strict '>' and the bytes
    walked back."""
    T, S = emit.shape
    per_step = trans.shape[0] != 1
    cap = S if not per_step and S <= 8 else (8 if S <= 8 else 32)
    steps = _ring_steps(cap, per_step)
    pad = torch.full((cap - S, S), -torch.inf, dtype=torch.float64)
    trc = torch.cat([trans[0], pad])
    delta = start + emit[0]
    words = np.zeros(((T + 6) // 8, S), dtype=np.uint64)
    for t_lo in range(1, T, steps):
        ring_emit = emit[t_lo : t_lo + steps]
        ring_trans = trans[t_lo - 1 : t_lo - 1 + steps] if per_step else None
        for u in range(len(ring_emit)):
            t = t_lo + u
            if per_step:
                trc = torch.cat([ring_trans[u], pad])
            lanes = torch.cat([delta, delta[-1:].expand(cap - S)])
            cand = list(lanes[:, None] + trc)
            z = torch.where(torch.stack([torch.signbit(c) for c in cand]).all(0), -0.0, 0.0)
            m = list(cand)
            a = [torch.full((S,), i) for i in range(cap)]
            w = 1
            while w < cap:
                for i in range(0, cap - w, 2 * w):
                    up = m[i + w] > m[i]
                    m[i] = torch.where(up, m[i + w], m[i])
                    a[i] = torch.where(up, a[i + w], a[i])
                w *= 2
            top, arg = m[0], a[0]
            delta = top + (z.double() + ring_emit[u])
            words[(t - 1) // 8] |= arg.numpy().astype(np.uint64) << np.uint64(8 * ((t - 1) % 8))
    top, state = delta[0], 0
    for i in range(1, S):
        if delta[i] > top:
            top, state = delta[i], i
    back = words.view(np.uint8).reshape(-1, S, 8)  # little-endian bytes of the words
    path = [state]
    for r in range(T - 2, -1, -1):
        state = int(back[r // 8, state, r % 8])
        path.append(state)
    return torch.tensor(path[::-1], dtype=torch.int32), top


@pytest.mark.parametrize("name", ALL)
def test_kernel_lane_model_equals_plain_loop(name):
    start, trans, emit = map(T_, _case(name))
    want_path, want_best = thmm.viterbi_log_ref(start, trans, emit)
    path, best = _kernel_model(start, trans, emit)
    assert torch.equal(path, want_path)
    assert _bits(best) == _bits(want_best)


def _ragged_batch(S, lengths=(1, 2, 33, 257), seed=20):
    """Shared-transition HMMs of S states, one per length: the per-sequence
    arrays, and the batch as viterbi_log_batch takes it."""
    hmms = [_hmm(seed + k, T, S) for k, T in enumerate(lengths)]
    batch = (np.stack([h[0] for h in hmms]), np.concatenate([h[1] for h in hmms]),
             np.concatenate([h[2] for h in hmms]))
    return hmms, batch


@pytest.mark.parametrize("S", [1, 5, 32])
def test_viterbi_log_batch_ragged_equals_loop_and_jax(S):
    lengths = (1, 2, 33, 257)
    hmms, batch = _ragged_batch(S, lengths)
    paths, best = thmm.viterbi_log_batch(*map(T_, batch), lengths)
    assert paths.dtype == torch.int32 and paths.shape == (sum(lengths),)
    assert best.dtype == torch.float64 and best.shape == (len(lengths),)
    r0 = 0
    for k, (T, h) in enumerate(zip(lengths, hmms)):
        want_path, want_best = thmm.viterbi_log_ref(*map(T_, h))
        assert torch.equal(paths[r0 : r0 + T], want_path)
        assert _bits(best[k]) == _bits(want_best)
        jax_path, jax_best = jhmm.viterbi_log(*h)
        np.testing.assert_array_equal(paths[r0 : r0 + T].numpy(), np.asarray(jax_path))
        assert _bits(best[k]) == _bits(jax_best)
        r0 += T


def test_viterbi_log_batch_per_step_batch_of_one():
    start, trans, emit = _hmm(2, 64, 5, per_step=True)
    paths, best = thmm.viterbi_log_batch(T_(start[None]), T_(trans), T_(emit), [64])
    want_path, want_best = thmm.viterbi_log_ref(T_(start), T_(trans), T_(emit))
    assert torch.equal(paths, want_path) and _bits(best[0]) == _bits(want_best)


def test_ragged_layout_offsets():
    """Row offsets of the concatenated emissions and paths, and back-pointer
    word offsets: ceil((T-1)/8) x S 64-bit words a sequence (a word a state
    per 8 steps); a sequence of T = 1 has none."""
    layout = thmm.ragged_layout([1, 2, 9, 17, 8], 5)
    assert layout.dtype == torch.int64
    assert layout.tolist() == [[0, 1, 3, 12, 29, 37], [0, 0, 5, 10, 20, 25]]
    assert thmm.ragged_layout([], 3).tolist() == [[0], [0]]
    with pytest.raises(ValueError):
        thmm.ragged_layout([3, 0], 2)


@pytest.mark.parametrize("case", ["lengths_sum", "start_shape", "per_step_batch", "device"])
def test_viterbi_log_batch_rejects_bad_arguments(case):
    hmms, (start, trans, emit) = _ragged_batch(3, (4, 6))
    start, trans, emit = T_(start), T_(trans), T_(emit)
    lengths, exc = [4, 6], ValueError
    if case == "lengths_sum":
        lengths = [4, 5]
    elif case == "start_shape":
        start = start[:1]
    elif case == "per_step_batch":
        trans = T_(np.zeros((9, 3, 3)))
    elif case == "device":
        start, trans, emit = (x.to("meta") for x in (start, trans, emit))
    with pytest.raises(exc):
        thmm.viterbi_log_batch(start, trans, emit, lengths)


@pytest.mark.parametrize("name", [n for n in ALL if n != "T1"])
def test_forward_backward_posterior_within_rounding_of_jax(name):
    start, trans, emit = _case(name)
    args = (T_(start), T_(trans), T_(emit))
    want_alpha, want_ll = jhmm.forward_log(start, trans, emit)
    alpha, ll = thmm.forward_log(*args)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(want_alpha), rtol=0, atol=1e-10)
    assert abs(float(ll) - float(want_ll)) < 1e-10
    beta = thmm.backward_log(args[1], args[2])
    np.testing.assert_allclose(
        beta.numpy(), np.asarray(jhmm.backward_log(trans, emit)), rtol=0, atol=1e-10
    )
    want_post, _ = jhmm.posterior_log(start, trans, emit)
    post, ll2 = thmm.posterior_log(*args)
    assert float(ll2) == float(ll)
    np.testing.assert_allclose(post.numpy(), np.asarray(want_post), rtol=0, atol=1e-10)
    np.testing.assert_allclose((10.0 ** post.numpy()).sum(axis=1), 1.0, atol=1e-10)


@pytest.mark.parametrize("name", [n for n in ALL if n != "T1"])
def test_baum_welch_counts_within_rounding_of_jax(name):
    start, trans, emit = _case(name)
    want_trans, want_gamma, want_ll = jhmm.baum_welch_expected_counts(start, trans, emit)
    exp_trans, gamma, ll = thmm.baum_welch_expected_counts(T_(start), T_(trans), T_(emit))
    np.testing.assert_allclose(exp_trans.numpy(), np.asarray(want_trans), rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(want_gamma), rtol=1e-10, atol=1e-300)
    assert abs(float(ll) - float(want_ll)) < 1e-10
    assert abs(float(exp_trans.sum()) - (emit.shape[0] - 1)) < 1e-8


def test_unreachable_states_stay_minus_inf():
    """A state no path reaches has alpha = -inf: _log10sumexp's guard for a
    non-finite maximum, as in the JAX package."""
    start = np.array([0.0, -np.inf])
    trans = np.array([[[0.0, -np.inf], [-np.inf, 0.0]]])
    emit = np.log10(np.full((4, 2), 0.5))
    alpha, ll = thmm.forward_log(T_(start), T_(trans), T_(emit))
    want_alpha, want_ll = jhmm.forward_log(start, trans, emit)
    np.testing.assert_array_equal(np.isneginf(alpha.numpy()), np.isneginf(np.asarray(want_alpha)))
    assert np.isneginf(alpha.numpy()[:, 1]).all()
    assert abs(float(ll) - float(want_ll)) < 1e-12


@pytest.mark.parametrize(
    "case,exc",
    [("dtype", TypeError), ("numpy", TypeError), ("start_shape", ValueError),
     ("trans_steps", ValueError), ("trans_square", ValueError), ("empty", ValueError)],
)
def test_viterbi_rejects_bad_arguments(case, exc):
    start, trans, emit = map(T_, _hmm(9, 6, 3))
    if case == "dtype":
        emit = emit.float()
    elif case == "numpy":
        start = start.numpy()
    elif case == "start_shape":
        start = start[:2]
    elif case == "trans_steps":
        trans = trans.expand(3, 3, 3)
    elif case == "trans_square":
        trans = trans[:, :2]
    elif case == "empty":
        emit = emit[:0]
    with pytest.raises(exc):
        thmm.viterbi_log(start, trans, emit)


# ---- posterior_log_batch: the imputer's E-step (csrc/forward_backward.cu) ----

def _fb_batch(seed, n, T, S, per_step=False, neg_inf=False, dead_state=False):
    """n sequences of T steps sharing a random log10 HMM of S states; with
    dead_state, no start and no transition reaches state S-1 (its alpha
    and posterior are -inf at every step)."""
    start, trans, _ = _hmm(seed, T, S, per_step, neg_inf)
    emit = np.log10(np.random.default_rng(seed + 100).random((n, T, S)))
    if dead_state:
        start[-1] = -np.inf
        trans[:, :, -1] = -np.inf
    return start, trans, emit


FB_CASES = {
    "S4_shared": dict(seed=31, n=3, T=50, S=4),
    "S4_per_step": dict(seed=32, n=2, T=40, S=4, per_step=True),
    "S16_shared_neg_inf": dict(seed=33, n=3, T=60, S=16, neg_inf=True),
    "S16_per_step": dict(seed=34, n=2, T=30, S=16, per_step=True),
    "S64_shared": dict(seed=35, n=2, T=40, S=64),
    "S64_per_step": dict(seed=36, n=3, T=25, S=64, per_step=True),
    "S64_per_step_dead_state": dict(seed=37, n=2, T=25, S=64, per_step=True,
                                    dead_state=True),
    "S5_T1": dict(seed=38, n=3, T=1, S=5, per_step=True),
    "S1_n1": dict(seed=39, n=1, T=12, S=1),
}


@pytest.mark.parametrize("name", sorted(FB_CASES))
def test_posterior_log_batch_equals_jax_vmap(name):
    """posterior_log_batch on the CPU against jax.vmap(posterior_log) over
    the samples: posteriors and log-likelihoods within 1e-10 absolute in
    log10 (a dead state's -inf exactly)."""
    import jax

    start, trans, emit = _fb_batch(**FB_CASES[name])
    want_post, want_ll = jax.vmap(jhmm.posterior_log, in_axes=(None, None, 0))(
        start, trans, emit)
    post, ll = thmm.posterior_log_batch(T_(start), T_(trans), T_(emit))
    assert post.shape == emit.shape and ll.shape == (emit.shape[0],)
    want_post, want_ll = np.asarray(want_post), np.asarray(want_ll)
    np.testing.assert_array_equal(np.isneginf(post.numpy()), np.isneginf(want_post))
    np.testing.assert_allclose(post.numpy(), want_post, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ll.numpy(), want_ll, rtol=0, atol=1e-10)
    if FB_CASES[name].get("dead_state"):
        assert np.isneginf(post.numpy()[:, :, -1]).all()
    # every sequence's posteriors sum to one at every step
    np.testing.assert_allclose((10.0 ** post.numpy()).sum(axis=2), 1.0, atol=1e-10)


def _fb_kernel_model(start, trans, emit):
    """forward_backward_kernel of csrc/forward_backward.cu, its arithmetic
    statement by statement with samples and states as tensor axes: a row
    lse takes four partial maxima and sums (row r into sum r mod 4, in
    ascending r, then (s0 + s1) + (s2 + s3)); an lse over a sample's states
    sums each warp's 32 lanes (zero past S) by a shfl_down tree of offsets
    16, 8, 4, 2, 1 and then the warps in order.  Chunking and samples per
    block change no arithmetic.  torch.pow stands for exp10."""
    n, T, S = emit.shape
    per_step = trans.shape[0] != 1

    def finish(mx, total):
        finite = torch.isfinite(mx)
        ms = torch.where(finite, mx, 0.0)
        return torch.where(finite, ms + torch.log10(total), mx)

    def row_lse(v, M):  # lse_r(v[:, r] + M[r, c]) -> (n, C)
        x = v[:, :, None] + M[None]
        mx = x.amax(1)
        ms = torch.where(torch.isfinite(mx), mx, 0.0)
        s = [torch.zeros_like(mx) for _ in range(4)]
        for r in range(x.shape[1]):
            s[r % 4] = s[r % 4] + torch.pow(10.0, x[:, r] - ms)
        return finish(mx, (s[0] + s[1]) + (s[2] + s[3]))

    def group_lse(u):  # lse over the states of each sample -> (n,)
        mx = u.amax(1)
        ms = torch.where(torch.isfinite(mx), mx, 0.0)
        lanes = -(-S // 32) * 32
        x = torch.zeros((n, lanes), dtype=u.dtype)
        x[:, :S] = torch.pow(10.0, u - ms[:, None])
        x = x.view(n, lanes // 32, 32).clone()
        for o in (16, 8, 4, 2, 1):
            x[..., :o] = x[..., :o] + x[..., o : 2 * o]
        total = x[:, 0, 0]
        for w in range(1, lanes // 32):
            total = total + x[:, w, 0]
        return finish(mx, total)

    alpha = torch.empty_like(emit)
    alpha[:, 0] = start + emit[:, 0]
    for t in range(1, T):
        alpha[:, t] = row_lse(alpha[:, t - 1], trans[t - 1 if per_step else 0]) + emit[:, t]
    ll = group_lse(alpha[:, T - 1])
    post = torch.empty_like(emit)
    beta = torch.zeros_like(emit[:, 0])
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            M = trans[t if per_step else 0].T  # the tile of the backward pass
            beta = row_lse(emit[:, t + 1] + beta, M)
        un = alpha[:, t] + beta
        post[:, t] = un - group_lse(un)[:, None]
    return post, ll


@pytest.mark.parametrize("name", sorted(FB_CASES))
def test_fb_kernel_model_equals_plain_loop(name):
    """The kernel's summation order against the plain batched loop: within
    1e-12 absolute in log10 (the two differ only in the order of sums)."""
    args = tuple(map(T_, _fb_batch(**FB_CASES[name])))
    want_post, want_ll = thmm.posterior_log_batch_ref(*args)
    post, ll = _fb_kernel_model(*args)
    assert torch.equal(torch.isneginf(post), torch.isneginf(want_post))
    np.testing.assert_allclose(post.numpy(), want_post.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ll.numpy(), want_ll.numpy(), rtol=0, atol=1e-12)


# the product form: the route by its precondition, and a model of its kernel

def _imputer_window(seed, n, T, K, missing=0.2):
    """The imputer's E-step input through the port's own builders: log start,
    per-step transitions of random SNV spacing (_transition_matrix) and the
    emissions of random theta and dosages (_diploid_emissions)."""
    from ngsepcore_tpu_torch.imputation.genotype_imputer import (
        _diploid_emissions, _transition_matrix)

    rng = np.random.default_rng(seed)
    positions = np.sort(rng.choice(10_000_000, size=T, replace=False))
    recomb_p = np.clip(1.0 - np.exp(-0.001 * np.maximum(np.diff(positions), 1) / 1e5),
                       1e-6, 0.49)
    trans = _transition_matrix(recomb_p, K)
    start = np.full(K * K, -np.log10(K * K))
    theta = np.clip(rng.random((T, K)), 1e-3, 1 - 1e-3)
    dos = rng.integers(0, 3, size=(n, T)).astype(np.int8)
    dos[rng.random((n, T)) < missing] = -1
    emit = _diploid_emissions(T_(theta), T_(dos)).numpy()
    return start, trans, emit


def _fb_input(name):
    if name == "imputer_window":
        return _imputer_window(41, 6, 60, 4)
    if name == "past_the_range":
        # emissions of -300 on alternate states: R_E = 300, 3 R_E > 250
        start, trans, emit = _fb_batch(42, 2, 20, 8)
        emit[:, :, 1::2] = -300.0
        return start, trans, emit
    return _fb_batch(**FB_CASES[name])


FB_FORM = {"S4_shared": "product", "S4_per_step": "product", "S16_shared_neg_inf": "log",
           "S16_per_step": "product", "S64_shared": "product", "S64_per_step": "product",
           "S64_per_step_dead_state": "log", "S5_T1": "product", "S1_n1": "product",
           "imputer_window": "product", "past_the_range": "log"}


@pytest.mark.parametrize("name", sorted(FB_FORM))
def test_fb_form_routes_by_the_precondition(name):
    """Finite inputs within the range take the product form; -inf
    transitions, a dead state and emissions 300 decades apart the log form,
    and naming the product form for them raises.  Either form gives the
    plain loop's answer on the CPU."""
    start, trans, emit = map(T_, _fb_input(name))
    assert thmm.fb_form(start, trans, emit) == FB_FORM[name]
    want = thmm.posterior_log_batch_ref(start, trans, emit)
    got = thmm.posterior_log_batch(start, trans, emit, form="log")
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    if FB_FORM[name] == "log":
        with pytest.raises(ValueError, match="range"):
            thmm.posterior_log_batch(start, trans, emit, form="product")
    else:
        got = thmm.posterior_log_batch(start, trans, emit, form="product")
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def _fb_product_model(start, trans, emit):
    """The product form of csrc/forward_backward.cu (fb_prepare_kernel,
    fb_product_kernel, fb_posterior_kernel), its arithmetic statement by
    statement with samples and (padded) states as tensor axes: P = 10^(M -
    gmax) in an Sp x Sp tile (Sp: S rounded up to 8, zeros past S), E^ =
    10^(e - e[0]); a step's product in k-steps of four, k-step kk into
    accumulator kk mod 4 (each k added in ascending order: the DMMA's own
    order within a k-step is the hardware's), summed (acc0 + acc1) + (acc2 +
    acc3); the scale 2^-k of column 0's power of two; ll's row sum of lane
    pairs (columns 8w + 2q, + 1), the four lanes of a group as (l0 + l1) +
    (l2 + l3) and the warps' sums in ascending order; the posterior pass's
    row sum of states l and l + 32, then a shfl_down tree into lane 0."""
    n, T, S = emit.shape
    per_step = trans.shape[0] != 1
    Sp = -(-S // 8) * 8
    W = Sp // 8
    gmax = trans.amax(dim=(1, 2)) if trans.shape[0] else trans.new_zeros(0)
    P = torch.zeros((trans.shape[0], Sp, Sp), dtype=torch.float64)
    P[:, :S, :S] = torch.pow(10.0, trans - gmax[:, None, None])
    E = torch.zeros((n, T, Sp), dtype=torch.float64)
    E[:, :, :S] = torch.pow(10.0, emit - emit[:, :, :1])

    def inverse_power_of_two(x):  # 2^-k, k for the power of two 2^k of x
        k = torch.frexp(x).exponent.long() - 1
        return torch.ldexp(torch.ones_like(x), -k), k

    def products(X, M):  # X (n, Sp) @ M (Sp, Sp)
        acc = [torch.zeros((n, Sp), dtype=torch.float64) for _ in range(4)]
        for kk in range(Sp // 4):
            for k in range(4 * kk, 4 * kk + 4):
                acc[kk % 4] = acc[kk % 4] + X[:, k : k + 1] * M[k]
        return (acc[0] + acc[1]) + (acc[2] + acc[3])

    def ll_row_sum(x):
        lanes = x.view(n, W, 4, 2)
        lanes = lanes[..., 0] + lanes[..., 1]
        warps = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
        total = warps[:, 0]
        for w in range(1, W):
            total = total + warps[:, w]
        return total

    def posterior(u):  # u (n, Sp) -> log10 posteriors (n, S)
        x = torch.zeros((n, 64), dtype=torch.float64)
        x[:, :S] = u[:, :S]
        x = x[:, :32] + x[:, 32:]
        for o in (16, 8, 4, 2, 1):
            x[:, :o] = x[:, :o] + x[:, o : 2 * o]
        return torch.log10(u[:, :S]) - torch.log10(x[:, 0])[:, None]

    ref = start[0] + emit[:, 0, 0]
    a = torch.zeros((n, Sp), dtype=torch.float64)
    a[:, :S] = torch.pow(10.0, (start + emit[:, 0]) - ref[:, None])
    L, K = ref.clone(), torch.zeros(n, dtype=torch.int64)
    alphas = [a]
    for t in range(1, T):
        s, k = inverse_power_of_two(a[:, 0])
        y = products(a, P[t - 1 if per_step else 0])
        a = (y * s[:, None]) * E[:, t]
        alphas.append(a)
        L = L + (gmax[t - 1 if per_step else 0] + emit[:, t, 0])
        K = K + k
    ll = (L + K.double() * math.log10(2.0)) + torch.log10(ll_row_sum(a))
    post = torch.empty_like(emit)
    post[:, T - 1] = posterior(a)
    z = E[:, T - 1]
    for t in range(T - 2, -1, -1):
        s, _ = inverse_power_of_two(z[:, 0])
        bb = products(z, P[t if per_step else 0].T) * s[:, None]
        z = bb * E[:, t]
        post[:, t] = posterior(alphas[t] * bb)
    return post, ll


@pytest.mark.parametrize("name", sorted(n for n, f in FB_FORM.items() if f == "product"))
def test_fb_product_model_equals_plain_loop_and_jax(name):
    """The product form's arithmetic against the plain batched loop within
    1e-12 absolute in log10 (posteriors and ll), and against
    jax.vmap(posterior_log) within 1e-10."""
    import jax

    start, trans, emit = _fb_input(name)
    args = tuple(map(T_, (start, trans, emit)))
    post, ll = _fb_product_model(*args)
    want_post, want_ll = thmm.posterior_log_batch_ref(*args)
    assert not torch.isneginf(want_post).any()
    np.testing.assert_allclose(post.numpy(), want_post.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ll.numpy(), want_ll.numpy(), rtol=0, atol=1e-12)
    jax_post, jax_ll = jax.vmap(jhmm.posterior_log, in_axes=(None, None, 0))(start, trans, emit)
    np.testing.assert_allclose(post.numpy(), np.asarray(jax_post), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jax_ll), rtol=0, atol=1e-10)


@pytest.mark.parametrize(
    "case,exc",
    [("dtype", TypeError), ("emit_dims", ValueError), ("start_shape", ValueError),
     ("trans_steps", ValueError), ("device", ValueError), ("too_many_states", ValueError),
     ("unknown_form", ValueError), ("product_too_many_states", ValueError)],
)
def test_posterior_log_batch_rejects_bad_arguments(case, exc):
    start, trans, emit = map(T_, _fb_batch(40, 2, 6, 3))
    if case == "dtype":
        emit = emit.float()
    elif case == "emit_dims":
        emit = emit[0]
    elif case == "start_shape":
        start = start[:2]
    elif case == "trans_steps":
        trans = trans.expand(3, 3, 3)
    elif case == "device":
        start, trans, emit = (x.to("meta") for x in (start, trans, emit))
    elif case == "too_many_states":
        S = thmm.MAX_FB_STATES + 1
        start, trans, emit = torch.zeros(S, dtype=torch.float64), torch.zeros(
            (1, S, S), dtype=torch.float64), torch.zeros((1, 2, S), dtype=torch.float64)
    form = {"unknown_form": "fast", "product_too_many_states": "product"}.get(case)
    if case == "product_too_many_states":
        S = thmm.PRODUCT_MAX_STATES + 1
        start, trans, emit = torch.zeros(S, dtype=torch.float64), torch.zeros(
            (1, S, S), dtype=torch.float64), torch.zeros((1, 2, S), dtype=torch.float64)
    with pytest.raises(exc, match="1024" if case == "too_many_states" else None):
        thmm.posterior_log_batch(start, trans, emit, form=form)
