"""ngsepcore_tpu_torch's PairedReadsAligner must pair, flag and annotate
the ends exactly like the JAX package's, on tests/test_paired.py's inputs
(CPU)."""
import numpy as np
import pytest
import torch

from ngsepcore_tpu.align.paired import PairedReadsAligner as JPaired
from ngsepcore_tpu.align.reads_aligner import ReadsAligner as JAligner
from ngsepcore_tpu.core.genome import ReferenceGenome as JGenome
from ngsepcore_tpu.core.sequences import QualifiedSequence as JQS
from ngsepcore_tpu.core.sequences import QualifiedSequenceList as JQSL
from ngsepcore_tpu.core.sequences import RawRead as JRawRead
from ngsepcore_tpu.core.sequences import reverse_complement
from ngsepcore_tpu_torch.align.paired import PairedReadsAligner as TPaired
from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner as TAligner
from ngsepcore_tpu_torch.core.genome import ReferenceGenome as TGenome
from ngsepcore_tpu_torch.core.sequences import QualifiedSequence as TQS
from ngsepcore_tpu_torch.core.sequences import QualifiedSequenceList as TQSL
from ngsepcore_tpu_torch.core.sequences import RawRead as TRawRead

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(55)
    seq = "".join(rng.choice(list("ACGT"), size=40000))
    jgen = JGenome(JQSL([JQS.from_string("chr1", seq)]))
    tgen = TGenome(TQSL([TQS.from_string("chr1", seq)]))
    return seq, JAligner(jgen), TAligner(tgen, device="cpu")


def _make_pairs(rng, seq, n, insert=400, read_len=100):
    reads1, reads2 = [], []
    for i in range(n):
        s = int(rng.integers(0, len(seq) - insert))
        frag = seq[s : s + insert]
        reads1.append(JRawRead(f"p{i}/1", frag[:read_len], "I" * read_len))
        reads2.append(
            JRawRead(f"p{i}/2", reverse_complement(frag[-read_len:]), "I" * read_len)
        )
    return reads1, reads2


def _cases(seq, which):
    if which == "proper":
        return _make_pairs(np.random.default_rng(9), seq, 30)
    if which == "mate_unmapped":
        return (
            [JRawRead("x/1", seq[1000:1100], "I" * 100)],
            [JRawRead("x/2", "N" * 100, "I" * 100)],
        )
    return (
        [JRawRead("d/1", seq[1000:1100], "I" * 100)],
        [JRawRead("d/2", reverse_complement(seq[20000:20100]), "I" * 100)],
    )


def _port(reads):
    return [TRawRead(name=r.name, sequence=r.sequence, qualities=r.qualities)
            for r in reads]


@pytest.mark.parametrize("which", ["proper", "mate_unmapped", "distant"])
def test_paired_equals_jax(setup, which):
    seq, ja, ta = setup
    r1, r2 = _cases(seq, which)
    jp, tp = JPaired(ja), TPaired(ta)
    jres = jp.align_batch(r1, r2)
    tres = tp.align_batch(_port(r1), _port(r2))
    assert (tp.pairs, tp.proper_pairs) == (jp.pairs, jp.proper_pairs)
    fields = lambda res: [
        ["\t".join(a.to_sam_fields()) for a in alns] for alns in res
    ]
    assert fields(tres) == fields(jres)
    if which == "proper":
        assert tp.proper_pairs == 30
        assert all(a.is_proper_pair for alns in tres for a in alns)
    elif which == "mate_unmapped":
        (a,) = tres[0]
        assert a.flags & 8 and a.alignment_quality <= 50
    else:
        assert all(a.is_paired and not a.is_proper_pair for a in tres[0])
