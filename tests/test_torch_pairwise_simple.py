"""The port's simple-gap, banded and affine-gap pairwise aligners and its
dp_stats_pack against the JAX package on the CPU (ROADMAP.md item 17h).

The cases of tests/test_pairwise_variants.py run through both packages'
aligners: gapped strings and scores must be equal, and the port's must
also pass that file's checks against the numpy mirror of the reference's
DP.  The batch entry points are held output by output on padded batches
of unequal lengths, and dp_stats_pack on tests/test_device_left_align.py's
inputs.  Integers and strings are exact."""
import numpy as np
import pytest
import torch

import ngsepcore_tpu.align.pairwise_aligners as jal
import ngsepcore_tpu.kernels.pairwise as jpw
import ngsepcore_tpu.kernels.pairwise_simple as jps
import ngsepcore_tpu_torch.align.pairwise_aligners as tal
import ngsepcore_tpu_torch.kernels.pairwise as tpw
import ngsepcore_tpu_torch.kernels.pairwise_simple as tps
from test_device_left_align import _simulate as _left_align_inputs
from test_pairwise_variants import _mirror_banded, _mirror_simple, _rand_seq

torch.set_num_threads(1)

BASES = "ACGT"


def _both(make, s1, s2, calc="calculate_alignment"):
    """((strings, score) of the JAX aligner, the same of the port's)."""
    out = []
    for al in (make(jal, {}), make(tal, {"device": "cpu"})):
        got = getattr(al, calc)(s1, s2)
        out.append((got, al.max_score))
    return out


def _score(a1, a2, match=1, mismatch=1, gap=2):
    return sum((match if c1 == c2 else -mismatch) if "-" not in (c1, c2) else -gap
               for c1, c2 in zip(a1, a2))


@pytest.mark.parametrize("flags", [
    dict(),
    dict(fe2=False),
    dict(fe1=False),
    dict(fs1=False),
    dict(fs2=False),
    dict(fs2=False, fe2=False),
])
def test_simple_gap_scores_match_mirror(flags):
    rng = np.random.default_rng(3)
    for trial in range(6):
        s1 = _rand_seq(rng, int(rng.integers(5, 40)))
        s2 = _rand_seq(rng, int(rng.integers(5, 40)))

        def make(m, kw):
            al = m.PairwiseAlignerSimpleGap(**kw)
            al.force_start1 = flags.get("fs1", True)
            al.force_start2 = flags.get("fs2", True)
            al.force_end1 = flags.get("fe1", True)
            al.force_end2 = flags.get("fe2", True)
            return al

        j, t = _both(make, s1, s2)
        assert t == j, (s1, s2, flags)
        (a1, a2), score = t
        assert score == _mirror_simple(s1, s2, **flags)
        assert a1.replace("-", "") == s1 and a2.replace("-", "") == s2
        assert len(a1) == len(a2)


def test_simple_gap_local():
    rng = np.random.default_rng(5)
    for trial in range(8):
        s1 = _rand_seq(rng, int(rng.integers(8, 50)))
        s2 = _rand_seq(rng, int(rng.integers(8, 50)))

        def make(m, kw):
            al = m.PairwiseAlignerSimpleGap(**kw)
            al.set_local(True)
            return al

        j, t = _both(make, s1, s2)
        assert t == j
        (a1, a2), score = t
        assert score == _mirror_simple(s1, s2, fs1=False, fs2=False, fe1=False, fe2=False,
                                       local=True)
        assert len(a1) == len(a2) and _score(a1, a2) == score
        assert a1.replace("-", "") in s1 and a2.replace("-", "") in s2


def test_simple_gap_exact_known():
    make = lambda m, kw: m.PairwiseAlignerSimpleGap(**kw)
    j, t = _both(make, "ACGT", "ACGT")
    assert t == j == (("ACGT", "ACGT"), 4)
    j, t = _both(make, "ACGT", "AGT")
    assert t == j and t[1] == 1
    assert t[0][0].replace("-", "") == "ACGT" and t[0][1].replace("-", "") == "AGT"


@pytest.mark.parametrize("k", [2, 3, 6])
def test_banded_scores_match_mirror(k):
    rng = np.random.default_rng(11)
    for trial in range(6):
        n1 = int(rng.integers(10, 50))
        n2 = n1 + int(rng.integers(-k, k + 1))
        s1 = _rand_seq(rng, n1)
        s2 = list(_rand_seq(rng, n2)) if trial % 2 == 0 else list(s1[:n2])
        if trial % 2:
            for _ in range(3):
                p = int(rng.integers(0, len(s2)))
                s2[p] = BASES[int(rng.integers(0, 4))]
        s2 = "".join(s2)
        j, t = _both(lambda m, kw: m.PairwiseAlignerStaticBanded(k=k, **kw), s1, s2)
        assert t == j
        (a1, a2), score = t
        assert score == _mirror_banded(s1, s2, k)
        assert a1.replace("-", "") == s1 and a2.replace("-", "") == s2
        assert _score(a1, a2) == score


def test_banded_k_check():
    for m, kw in ((jal, {}), (tal, {"device": "cpu"})):
        with pytest.raises(ValueError):
            m.PairwiseAlignerStaticBanded(k=2, **kw).calculate_alignment("ACGTACGT", "ACG")


def test_banded_equals_full_nw_when_band_covers():
    rng = np.random.default_rng(17)
    s1 = _rand_seq(rng, 20)
    s2 = _rand_seq(rng, 18)
    j, t = _both(lambda m, kw: m.PairwiseAlignerStaticBanded(k=25, **kw), s1, s2,
                 calc="get_max_score")
    assert t == j and t[1] == _mirror_simple(s1, s2)


def test_naive():
    for gaps_left, s1, s2, want in ((True, "ACGT", "AC", ("ACGT", "--AC")),
                                    (False, "AC", "ACGT", ("AC--", "ACGT"))):
        for m in (jal, tal):
            assert m.PairwiseAlignerNaive(gaps_left=gaps_left).calculate_alignment(s1, s2) \
                == want


@pytest.mark.parametrize("ends", ["forced", "free_end1", "free_start2"])
def test_affine_gap_aligner_equals_jax(ends):
    """PairwiseAlignerAffineGap (the Gotoh forward pass and the run-jump
    walk; on the CPU their plain versions) against the JAX package's: with
    every force flag set, a free query end and a free subject start."""
    rng = np.random.default_rng(23)
    for trial in range(8):
        s1 = _rand_seq(rng, int(rng.integers(1, 60)))
        s2 = _rand_seq(rng, int(rng.integers(1, 60)))

        def make(m, kw):
            al = m.PairwiseAlignerAffineGap(**kw)
            if ends == "free_end1":
                al.force_end1 = False
            elif ends == "free_start2":
                al.force_start2 = False
            return al

        j, t = _both(make, s1, s2)
        assert t == j, (s1, s2)
        (a1, a2), _ = t
        # a free subject start leaves the subject's head out of the strings
        assert a1.replace("-", "") == s1 and a2.replace("-", "") in s2
        assert ends == "free_start2" or a2.replace("-", "") == s2


def _padded_batch(rng, B, Lq, Ls):
    """Code batches of unequal lengths (zero lengths included), padded
    with N past each length; half of the subjects mutated copies."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    sl = rng.integers(0, Ls + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        n = min(ql[b], Ls)
        s[b, :n] = q[b, :n]
        s[b, rng.integers(0, Ls, 3)] = rng.integers(0, 4, 3)
        sl[b] = max(sl[b], n)
    for b in range(B):
        q[b, ql[b]:] = 4
        s[b, sl[b]:] = 4
    return q, ql, s, sl


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(force_end1=False),
    dict(force_end2=False),
    dict(force_start1=False, force_start2=False),
    dict(local=True, force_start1=False, force_start2=False, force_end1=False,
         force_end2=False),
    dict(match=2, mismatch=3, gap=1),
])
def test_simple_gap_batch_equals_jax(cfg):
    """simple_gap_align_batch on a padded batch: every output equal."""
    rng = np.random.default_rng(31)
    q, ql, s, sl = _padded_batch(rng, 48, 40, 56)
    want = {k: np.asarray(v) for k, v in jps.simple_gap_align_batch(q, ql, s, sl, **cfg).items()}
    got = tps.simple_gap_align_batch(*map(torch.from_numpy, (q, ql, s, sl)), **cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].numpy().dtype == want[k].dtype, k


@pytest.mark.parametrize("k", [1, 3, 8])
def test_banded_batch_equals_jax(k):
    rng = np.random.default_rng(37)
    q, ql, s, sl = _padded_batch(rng, 40, 48, 52)
    sl = np.clip(sl, ql - k, ql + k).clip(0, 52).astype(np.int32)
    for b in range(len(sl)):
        s[b, sl[b]:] = 4
    want = {kk: np.asarray(v) for kk, v in jps.banded_align_batch(q, ql, s, sl, k=k).items()}
    got = tps.banded_align_batch(*map(torch.from_numpy, (q, ql, s, sl)), k=k)
    for kk in want:
        np.testing.assert_array_equal(got[kk].numpy(), want[kk], err_msg=kk)


@pytest.mark.parametrize("seed", [5, 17])
def test_dp_stats_pack_equals_jax(seed):
    """tests/test_device_left_align.py's inputs: the port's
    affine_gap_align_batch gives the JAX package's ops, and dp_stats_pack
    over them every output of the JAX package's, dtypes included."""
    rng = np.random.default_rng(seed)
    qc, ql, sc, sl = _left_align_inputs(rng, 256)
    jout = jpw.affine_gap_align_batch(qc, ql, sc, sl, free_start2=True, free_end2=True)
    want = {k: np.asarray(v) for k, v in jpw.dp_stats_pack(
        jout["ops"], jout["n_ops"], jout["start_j"], jout["score"], qc, sc).items()}
    args = [torch.from_numpy(x) for x in (qc, ql, sc, sl)]
    tout = tpw.affine_gap_align_batch(*args, free_start2=True, free_end2=True)
    for k in ("ops", "n_ops", "start_j", "score"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    got = tpw.dp_stats_pack(tout["ops"], tout["n_ops"], tout["start_j"], tout["score"],
                            args[0], args[2])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].numpy().dtype == want[k].dtype, k
    assert int(want["has_gap"].sum()) > 100  # gapped rows reach the left-alignment
