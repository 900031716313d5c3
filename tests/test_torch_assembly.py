"""ngsepcore_tpu_torch's de-novo assembler against the JAX package on the
CPU: the two device functions (default_kmer_hash, scatter_allele_counts),
the minimizers of the reads, the overlap graph (edges, embedded reads,
the saved file), the Kruskal and greedy layouts, whole assemblies on
tests/test_assembler.py's inputs, and the Assembler and
AssemblyGraphStatistics commands.  Integers, sequences and text exact;
the graph's float fields (score, ev_prop, ikbp, cost) are the same numpy
arithmetic in both packages and compared exactly (tolerance 0).  Each
workload's JAX run happens once, in a module fixture."""
import dataclasses
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngsepcore_tpu.__main__ import main as jmain
from ngsepcore_tpu.assembly.assembler import Assembler as JAssembler
from ngsepcore_tpu.assembly.layout import (
    LayoutBuilderGreedy as JGreedy,
    LayoutBuilderKruskalPath as JKruskal,
)
from ngsepcore_tpu.io.fastq import write_fastq
from ngsepcore_tpu.core.sequences import RawRead, decode_dna
from ngsepcore_tpu.kernels.genotyping import scatter_allele_counts as jscatter
from ngsepcore_tpu.kernels.minimizers import default_kmer_hash as jhash
from ngsepcore_tpu_torch.__main__ import main as tmain
from ngsepcore_tpu_torch.assembly.assembler import Assembler as TAssembler
from ngsepcore_tpu_torch.assembly.graph import AssemblyGraph as TGraph
from ngsepcore_tpu_torch.assembly.layout import (
    LayoutBuilderGreedy as TGreedy,
    LayoutBuilderKruskalPath as TKruskal,
)
from ngsepcore_tpu_torch.kernels.genotyping import scatter_allele_counts as tscatter
from ngsepcore_tpu_torch.kernels.minimizers import default_kmer_hash as thash
from test_assembler import _simulate_long_reads

# one torch thread per pytest-xdist worker: one per core oversubscribes the CPU
torch.set_num_threads(1)


def _single_contig_reads():
    """tests/test_assembler.py::test_assembles_single_contig's input."""
    rng = np.random.default_rng(13)
    genome = "".join(rng.choice(list("ACGT"), size=30000))
    return _simulate_long_reads(genome, 120, 2500, rng)


def _error_reads():
    """tests/test_assembler.py::test_assembly_with_errors' input."""
    rng = np.random.default_rng(5)
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    return _simulate_long_reads(genome, 100, 2000, rng, error_rate=0.005)


def _embedded_reads():
    """tests/test_assembler.py::test_embedded_reads_removed's input."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=12000))
    return (_simulate_long_reads(genome, 40, 3000, rng)
            + _simulate_long_reads(genome, 20, 600, rng))


def _seqs(contigs):
    return [(s.name, decode_dna(s.codes)) for s in contigs]


def test_default_kmer_hash_equals_jax():
    rng = np.random.default_rng(1)
    codes = np.concatenate([
        rng.integers(0, 1 << 30, 5000), rng.integers(0, 1 << 62, 5000),
        [0, 1073676286, 1073676287, (1 << 30) - 1, -1],
    ]).astype(np.int64)
    want = np.asarray(jhash(jnp.asarray(codes)))
    got = thash(torch.from_numpy(codes))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_size", [64, 1000])
def test_scatter_allele_counts_equals_jax(out_size):
    """Random calls with invalid rows: negative and too-large positions,
    allele -1 (skip) and 4 (past n_alleles), qualities 0..45 around
    MIN_BASE_QS and MAX_BASE_QS."""
    rng = np.random.default_rng(out_size)
    n = 20000
    pos = rng.integers(-5, out_size + 5, n).astype(np.int32)
    allele = rng.integers(-1, 5, n).astype(np.int8)
    qual = rng.integers(0, 46, n).astype(np.int8)
    strand = rng.integers(0, 2, n).astype(np.int8)
    want = jscatter(pos, allele, qual, strand, out_size=out_size)
    got = tscatter(*(torch.from_numpy(a) for a in (pos, allele, qual, strand)),
                   out_size=out_size)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[3].sum()) < n  # some calls dropped out


def test_read_minimizers_equal_jax():
    """Reads of 300-2500 bp in device batches of 8 rows: the port leaves
    out the JAX package's pad rows; every (code, read, pos, strand) is
    the same, in the same order."""
    rng = np.random.default_rng(4)
    reads = [rng.integers(0, 4, int(n)).astype(np.int8)
             for n in rng.integers(300, 2500, 21)]
    reads[3][100:140] = 4  # an N run
    want = JAssembler(batch_rows=8)._read_minimizers(reads)
    got = TAssembler(batch_rows=8, device="cpu")._read_minimizers(reads)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.array_equal(g, w)


def _graph_records(g):
    edges = [dataclasses.asdict(e) for e in g.edges]
    embedded = {k: dataclasses.asdict(v) for k, v in g.embedded.items()}
    return edges, embedded, sorted(g.chimeric)


@pytest.fixture(scope="module")
def embedded_graphs():
    """The unfiltered and the filtered graph of the embedded-reads input,
    both packages."""
    reads = _embedded_reads()
    out = {}
    for tag, asm in (("jax", JAssembler()), ("torch", TAssembler(device="cpu"))):
        raw = asm.build_graph(reads)
        out[tag] = (_graph_records(raw), asm._build_filtered_graph(reads))
    return out


def test_graph_edges_and_embedded_equal_jax(embedded_graphs):
    (jraw, jfilt), (traw, tfilt) = embedded_graphs["jax"], embedded_graphs["torch"]
    assert len(jraw[0]) > 50 and len(jraw[1]) >= 12
    assert traw == jraw
    assert _graph_records(tfilt) == _graph_records(jfilt)


def test_graph_save_load_bytes_equal_jax(embedded_graphs, tmp_path):
    """The filtered graph saved by both packages: the same text; the port
    loads the JAX package's file and saves it again byte for byte."""
    jfilt, tfilt = embedded_graphs["jax"][1], embedded_graphs["torch"][1]
    jfilt.save(str(tmp_path / "j.gz"))
    tfilt.save(str(tmp_path / "t.gz"))
    text = lambda p: gzip.open(tmp_path / p, "rb").read()
    assert text("t.gz") == text("j.gz") and len(text("j.gz")) > 1000
    TGraph.load(str(tmp_path / "j.gz")).save(str(tmp_path / "t2.gz"))
    assert text("t2.gz") == text("j.gz")


@pytest.mark.parametrize("builder", ["KruskalPath", "MaxOverlap", "MinCost"])
def test_layout_paths_equal_jax(embedded_graphs, builder):
    make = lambda kruskal, greedy: kruskal() if builder == "KruskalPath" else greedy(builder)
    jpaths = make(JKruskal, JGreedy).find_paths(embedded_graphs["jax"][1])
    tpaths = make(TKruskal, TGreedy).find_paths(embedded_graphs["torch"][1])
    assert jpaths
    assert [(p.reads, p.overlaps) for p in tpaths] == [(p.reads, p.overlaps) for p in jpaths]


@pytest.fixture(scope="module")
def jax_assemblies():
    return {name: _seqs(JAssembler().assemble(make()))
            for name, make in (("single", _single_contig_reads), ("errors", _error_reads))}


@pytest.mark.parametrize("name", ["single", "errors"])
def test_assemble_contigs_equal_jax(jax_assemblies, name):
    """Whole assembly (graph, filters, layout, polish, end merge) on
    tests/test_assembler.py's inputs: the same contigs, base for base."""
    make = _single_contig_reads if name == "single" else _error_reads
    asm = TAssembler(device="cpu")
    got = _seqs(asm.assemble(make()))
    assert got == jax_assemblies[name]
    assert len(got[0][1]) > 12000
    assert asm.corrections >= 0


def test_cli_assembler_and_graph_statistics_equal_jax(tmp_path, capsys):
    """Assembler then AssemblyGraphStatistics through both CLIs on the
    embedded-reads input as FASTQ: the contigs file and the statistics
    text equal."""
    reads = [RawRead(name=f"r{i}", sequence=decode_dna(c), qualities="I" * len(c))
             for i, c in enumerate(_embedded_reads())]
    fq = str(tmp_path / "reads.fastq")
    write_fastq(reads, fq)
    out = {}
    for tag, run, pre in (("j", jmain, []), ("t", tmain, ["--device", "cpu"])):
        run(pre + ["Assembler", fq, str(tmp_path / tag)])
        capsys.readouterr()
        run(pre + ["AssemblyGraphStatistics", str(tmp_path / f"{tag}_contigs.fa")])
        out[tag] = (open(tmp_path / f"{tag}_contigs.fa").read(), capsys.readouterr().out)
    assert out["t"] == out["j"]
    assert out["j"][0].startswith(">contig_1") and "N50\t" in out["j"][1]
