"""ngsepcore_tpu_torch.kernels.hmm against ngsepcore_tpu.kernels.hmm on the
CPU, on seeded numpy inputs: Viterbi path and best score equal (ties and
-inf transitions included), forward/backward/posterior within 1e-10
absolute in log10, Baum-Welch expected counts within 1e-10 relative in
linear space.  A torch model of csrc/viterbi.cu's lane decomposition is
held against the plain step loop bit for bit."""
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
    return _tie_hmm() if name == "tie" else _hmm(**CASES[name])


ALL = sorted(CASES) + ["tie"]


@pytest.mark.parametrize("name", ALL)
def test_viterbi_equals_jax(name):
    start, trans, emit = _case(name)
    want_path, want_best = jhmm.viterbi_log(start, trans, emit)
    path, best = thmm.viterbi_log(T_(start), T_(trans), T_(emit))
    assert path.dtype == torch.int32 and path.shape == (emit.shape[0],)
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    assert float(best) == float(want_best)
    if name == "tie":
        assert not path.any()


def _kernel_model(start, trans, emit):
    """viterbi_kernel of csrc/viterbi.cu, statement by statement with the
    lanes as a tensor axis: lane j takes the first maximum of delta[i] +
    trans[i][j] over kCap >= S candidates (those from S up are the last
    state's delta, which the idle lanes mirror, plus -inf) by the tree of
    pairwise strict '>' selects, packs the back pointers of a block of 8
    steps into the bytes of one 64-bit word, folds the last deltas with a
    strict '>', and walks the bytes back."""
    T, S = emit.shape
    cap = 8 if S <= 8 else 32
    per_step = trans.shape[0] != 1
    pad = torch.full((cap - S, S), -torch.inf, dtype=torch.float64)
    delta = start + emit[0]
    words = np.zeros(((T + 6) // 8, S), dtype=np.uint64)
    for t in range(1, T):
        tr = torch.cat([trans[t - 1 if per_step else 0], pad])
        lanes = torch.cat([delta, delta[-1:].expand(cap - S)])
        c = list(lanes[:, None] + tr)
        arg = [torch.full((S,), i, dtype=torch.int64) for i in range(cap)]
        w = 1
        while w < cap:
            for i in range(0, cap, 2 * w):
                upd = c[i + w] > c[i]
                c[i] = torch.where(upd, c[i + w], c[i])
                arg[i] = torch.where(upd, arg[i + w], arg[i])
            w *= 2
        delta = c[0] + emit[t]
        words[(t - 1) // 8] |= arg[0].numpy().astype(np.uint64) << np.uint64(8 * ((t - 1) % 8))
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
    assert float(best) == float(want_best)


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
