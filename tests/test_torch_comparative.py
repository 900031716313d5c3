"""The port's genome comparison and repeat finder against the JAX package
on the CPU (ROADMAP.md item 17e).

The cases of tests/test_comparative.py (MCL, homologs and orthogroups,
synteny blocks, the linear view) and tests/test_transposons.py run through
both packages with the JAX tests' own checks, and each output is held
against the JAX package's: clusters, orthogroups, synteny blocks and
annotations exactly, the HTML view byte for byte, GFF lines equal but for
the source column (each package writes its own name there).  MCL's float32
matrix agrees with the JAX package's within 1e-6 absolute: its products
may sum in another order.  A 1 Mbp bench.build_repeat_genome runs both
repeat-finder modes, and a random block matrix of 300 nodes runs MCL."""
import numpy as np
import pytest
import torch

import ngsepcore_tpu.core.genome as jgenome
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.genome.genomes_aligner as jga
import ngsepcore_tpu.genome.homologs as jhom
import ngsepcore_tpu.genome.synteny as jsyn
import ngsepcore_tpu.genome.transposons as jte
import ngsepcore_tpu.graphs.mcl as jmcl
import ngsepcore_tpu.kernels.minimizers as jmin
import ngsepcore_tpu_torch.core.genome as tgenome
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.genome.genomes_aligner as tga
import ngsepcore_tpu_torch.genome.homologs as thom
import ngsepcore_tpu_torch.genome.synteny as tsyn
import ngsepcore_tpu_torch.genome.transposons as tte
import ngsepcore_tpu_torch.graphs.mcl as tmcl
import ngsepcore_tpu_torch.kernels.minimizers as tmin

torch.set_num_threads(1)

AMINO = list("ARNDCQEGHILKMFPSTWYV")
M_ATOL = 1e-6  # MCL's float32 matrix, port against JAX


def _capture_jax_matrix(monkeypatch):
    """The JAX package's converged MCL matrix: its mcl_cluster reads M to
    the host with one np.asarray, captured here."""
    seen = []

    class _NP:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def asarray(a, *args, **kw):
            out = np.asarray(a, *args, **kw)
            seen.append(out)
            return out

    monkeypatch.setattr(jmcl, "np", _NP())
    return seen


def _mcl_both(sim, monkeypatch, **kw):
    seen = _capture_jax_matrix(monkeypatch)
    j = jmcl.mcl_cluster(sim, **kw)
    t = tmcl.mcl_cluster(sim, **kw, device="cpu")
    Mt, iters = tmcl.mcl_matrix(sim, **kw, device="cpu")
    np.testing.assert_allclose(Mt, seen[-1], rtol=0, atol=M_ATOL)
    assert t == j
    return t, iters


def _two_triangles():
    """tests/test_comparative.py::test_mcl_two_clusters' graph."""
    sim = np.zeros((6, 6), np.float32)
    for a, b in [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]:
        sim[a, b] = sim[b, a] = 10.0
    sim[2, 3] = sim[3, 2] = 0.5  # weak bridge
    return sim


def _block_matrix(n=300, n_blocks=25, seed=11):
    """A random block similarity matrix: strong weights inside blocks,
    sparse weak ones between them."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, n_blocks, size=n)
    inside = block[:, None] == block[None, :]
    sim = np.where(inside, rng.uniform(5, 50, (n, n)),
                   np.where(rng.random((n, n)) < 0.01, rng.uniform(0, 5, (n, n)), 0))
    sim = np.triu(sim, 1).astype(np.float32)
    return sim + sim.T


@pytest.mark.parametrize("case", ["two_triangles", "block_300", "block_300_inflation_3"])
def test_mcl_clusters_equal_jax(case, monkeypatch):
    if case == "two_triangles":
        clusters, _ = _mcl_both(_two_triangles(), monkeypatch)
        sets = [set(c) for c in clusters if len(c) > 1]
        assert {0, 1, 2} in sets and {3, 4, 5} in sets
        return
    sim = _block_matrix()
    kw = dict(inflation=3.0) if case.endswith("3") else {}
    clusters, iters = _mcl_both(sim, monkeypatch, **kw)
    assert 1 < iters < 100 and len(clusters) >= 20
    assert sorted(x for c in clusters for x in c) == list(range(len(sim)))


@pytest.mark.parametrize("n", [1, 3, 12, 64, 65, 130])
def test_mcl_rounds_in_the_stated_order(n):
    """The square and the column sums, modelled in numpy: up to 64 nodes the
    products added in k order, each partial sum rounded once from float64
    to float32, and rows added in order in float32; above, float64 product
    and sums rounded once.  Both devices run these orders."""
    rng = np.random.default_rng(n)
    M = rng.random((n, n)).astype(np.float32)
    M[rng.random((n, n)) < 0.3] = 0
    M /= M.sum(0, keepdims=True) + np.float32(1e-3)
    M[0, 0] = np.float32(1e-30)  # products far below a float32 ulp of the sum
    if n <= tmcl.EXACT_ORDER_MAX_NODES:
        want = np.zeros((n, n), np.float32)
        for k in range(n):
            want = (want + M[:, k : k + 1].astype(np.float64) * M[k : k + 1, :]).astype(np.float32)
        sums = M[0:1].copy()
        for i in range(1, n):
            sums = sums + M[i : i + 1]
    else:
        want = (M.astype(np.float64) @ M.astype(np.float64)).astype(np.float32)
        sums = M.astype(np.float64).sum(0, keepdims=True).astype(np.float32)
    t = torch.from_numpy(M)
    np.testing.assert_array_equal(tmcl._square(t).numpy(), want)
    np.testing.assert_array_equal(tmcl._column_sums(t).numpy(), sums)


def test_mcl_counts_calls_and_iterations():
    calls, iters = tmcl.mcl_cluster.calls, tmcl.mcl_cluster.iterations
    tmcl.mcl_cluster(_two_triangles(), device="cpu")
    assert tmcl.mcl_cluster.calls == calls + 1
    assert tmcl.mcl_cluster.iterations > iters
    assert tmcl.mcl_cluster(np.zeros((0, 0), np.float32), device="cpu") == []


def _mutate(rng, s, rate=0.05):
    out = list(s)
    for i in range(len(out)):
        if rng.random() < rate:
            out[i] = rng.choice(AMINO)
    return "".join(out)


def _families():
    """tests/test_comparative.py::test_homologs_and_orthogroups' proteins."""
    rng = np.random.default_rng(3)
    fam1 = "".join(rng.choice(AMINO, size=200))
    fam2 = "".join(rng.choice(AMINO, size=200))
    return [fam1, _mutate(rng, fam1), _mutate(rng, fam1), fam2, _mutate(rng, fam2)]


def _paralog_catalog(seed=5, n_orth=40, n_fam=6, n_par=4):
    """Two catalogs of single-copy orthologs (5% substitutions) and paralog
    families (15%): components of every size reach MCL."""
    rng = np.random.default_rng(seed)
    orth = ["".join(rng.choice(AMINO, size=int(rng.integers(120, 200)))) for _ in range(n_orth)]
    fams = ["".join(rng.choice(AMINO, size=int(rng.integers(120, 200)))) for _ in range(n_fam)]
    seqs = []
    for _ in range(2):
        seqs += [_mutate(rng, s, 0.05) for s in orth]
        seqs += [_mutate(rng, s, 0.15) for s in fams for _ in range(n_par)]
    return seqs


@pytest.mark.parametrize("case", ["families", "paralog_catalog"])
def test_homologs_and_orthogroups_equal_jax(case):
    seqs = _families() if case == "families" else _paralog_catalog()
    key = lambda rels: [(r.seq1, r.seq2, r.pct_shared) for r in rels]
    jr = jhom.HomologRelationshipsFinder().find_homologs(seqs)
    tr = thom.HomologRelationshipsFinder().find_homologs(seqs)
    assert key(tr) == key(jr)
    calls = tmcl.mcl_cluster.calls
    groups = thom.calculate_orthogroups(seqs, device="cpu")
    assert groups == jhom.calculate_orthogroups(seqs)
    sets = [set(g) for g in groups]
    if case == "families":
        pairs = {(r.seq1, r.seq2) for r in tr}
        assert (0, 1) in pairs and (0, 2) in pairs and (3, 4) in pairs
        assert not any((a in (0, 1, 2)) != (b in (0, 1, 2)) for a, b in pairs)
        assert {0, 1, 2} in sets and {3, 4} in sets
    else:
        assert tmcl.mcl_cluster.calls > calls
        assert sum(s == {i, i + 64} for i in range(40) for s in sets) >= 30


def _synteny_cases():
    """tests/test_comparative.py::test_synteny_blocks' gene orders."""
    gp1 = [("chrA", 1000 * i) for i in range(10)]
    gp2 = [("chr1", 500 * i) for i in range(10)]
    perm = np.random.default_rng(1).permutation(10)
    return {
        "collinear": (gp1, gp2, [(i, i) for i in range(10)], {}),
        "inversion": (gp1, gp2, [(i, 9 - i) for i in range(10)], {}),
        "shuffled": (gp1, gp2, [(i, int(perm[i])) for i in range(10)],
                     dict(min_block_genes=6)),
    }


@pytest.mark.parametrize("case", ["collinear", "inversion", "shuffled"])
def test_synteny_blocks_equal_jax(case):
    gp1, gp2, pairs, kw = _synteny_cases()[case]
    j = jsyn.find_synteny_blocks(gp1, gp2, pairs, **kw)
    t = tsyn.find_synteny_blocks(gp1, gp2, pairs, **kw)
    assert [vars(b) for b in t] == [vars(b) for b in j]
    if case == "collinear":
        assert len(t) == 1 and t[0].n_orthologs == 10
        assert t[0].first1 == 0 and t[0].last1 == 9000
    elif case == "inversion":
        assert len(t) == 1 and not t[0].same_strand
    else:
        assert t == []


def test_linear_view_html_equal_jax(tmp_path):
    def blocks(syn):
        return [
            syn.SyntenyBlock(seq1="chr1", first1=100, last1=5000, seq2="c2",
                             first2=200, last2=5200, n_orthologs=12, same_strand=True),
            syn.SyntenyBlock(seq1="chr1", first1=6000, last1=9000, seq2="c3",
                             first2=100, last2=3100, n_orthologs=5, same_strand=False),
        ]

    jga.GenomesAligner().write_linear_view(str(tmp_path / "j.html"), blocks(jsyn))
    tga.GenomesAligner(device="cpu").write_linear_view(str(tmp_path / "t.html"), blocks(tsyn))
    html = (tmp_path / "t.html").read_text()
    assert html == (tmp_path / "j.html").read_text()
    assert "<svg" in html and "addEventListener('wheel'" in html
    assert html.count('class="ribbon"') == 2 and 'data-seq2="c3"' in html


# ---- repeats ---------------------------------------------------------------

def _genomes(codes_or_str):
    """The same one-sequence genome in each package."""
    out = []
    for g, s in ((jgenome, jseq), (tgenome, tseq)):
        if isinstance(codes_or_str, str):
            q = s.QualifiedSequence.from_string("chr1", codes_or_str)
        else:
            q = s.QualifiedSequence("chr1", codes_or_str)
        out.append(g.ReferenceGenome(s.QualifiedSequenceList([q])))
    return out


def _ann_key(anns):
    return [(a.sequence_name, a.first, a.last, a.te_id, a.score) for a in anns]


def _gff_without_source(path):
    with open(path) as fh:
        return [l.split("\t")[:1] + l.split("\t")[2:] for l in fh]


def _both_gff(tmp_path, j, t, tag):
    jte.write_transposons_gff(j, str(tmp_path / f"{tag}_j.gff"))
    tte.write_transposons_gff(t, str(tmp_path / f"{tag}_t.gff"))
    got = _gff_without_source(tmp_path / f"{tag}_t.gff")
    assert got == _gff_without_source(tmp_path / f"{tag}_j.gff")
    return got


def test_denovo_repeats_equal_jax(tmp_path):
    """tests/test_transposons.py::test_denovo_repeat_discovery's genome."""
    rng = np.random.default_rng(6)
    unique = lambda n: "".join(rng.choice(list("ACGT"), size=n))
    te = unique(500)
    genome_str = unique(2000)
    for _ in range(15):
        genome_str += te + unique(1000)
    jg, tg = _genomes(genome_str)
    j = jte.find_repeats_denovo(jg, min_multiplicity=10, min_length=200)
    t = tte.find_repeats_denovo(tg, min_multiplicity=10, min_length=200, device="cpu")
    assert _ann_key(t) == _ann_key(j)
    assert len(t) >= 10 and sum(a.length() for a in t) > 10 * 400
    _both_gff(tmp_path, j, t, "denovo")


def test_library_search_equal_jax(tmp_path):
    """tests/test_transposons.py::test_library_search's genome."""
    rng = np.random.default_rng(9)
    unique = lambda n: "".join(rng.choice(list("ACGT"), size=n))
    te = unique(600)
    jg, tg = _genomes(unique(3000) + te + unique(3000) + te + unique(2000))
    extractions = tte.find_repeats_by_library.extractions
    j = jte.find_repeats_by_library(jg, [jseq.QualifiedSequence.from_string("TE1", te)],
                                    min_hits=5)
    t = tte.find_repeats_by_library(tg, [tseq.QualifiedSequence.from_string("TE1", te)],
                                    min_hits=5, device="cpu")
    assert tte.find_repeats_by_library.extractions == extractions + 1
    assert _ann_key(t) == _ann_key(j)
    assert len(t) == 2 and abs(t[0].first - 3001) < 50
    assert abs(t[1].first - (3000 + 600 + 3000 + 1)) < 50
    assert all(a.te_id == "TE1" for a in t)
    _both_gff(tmp_path, j, t, "library")


def _repeat_genome_1mbp():
    """bench.build_repeat_genome(rng 2024, 1 Mbp) and its 30 family source
    segments (chip_smoke.py's copy of the builder returns them)."""
    from bench import build_repeat_genome as bench_genome
    from chip_smoke import build_repeat_genome

    codes, _, _, families = build_repeat_genome(np.random.default_rng(2024), 1_000_000, 30, 400)
    np.testing.assert_array_equal(codes, bench_genome(np.random.default_rng(2024), 1_000_000)[0])
    return codes, [f[2] for f in families]


@pytest.fixture(scope="module")
def repeat_genome_1mbp():
    return _repeat_genome_1mbp()


@pytest.mark.parametrize("mode", ["denovo", "library"])
def test_repeat_finder_1mbp_gff_equal_jax(repeat_genome_1mbp, mode, tmp_path):
    codes, segments = repeat_genome_1mbp
    jg, tg = _genomes(codes)
    if mode == "denovo":
        j = jte.find_repeats_denovo(jg)
        t = tte.find_repeats_denovo(tg, device="cpu")
    else:
        lib = lambda s: [s.QualifiedSequence(f"family{i}", seg) for i, seg in enumerate(segments)]
        j = jte.find_repeats_by_library(jg, lib(jseq))
        t = tte.find_repeats_by_library(tg, lib(tseq), device="cpu")
    assert _ann_key(t) == _ann_key(j)
    assert len(_both_gff(tmp_path, j, t, mode)) == len(t) + 1 > 100


def test_library_minimizers_equal_jax(repeat_genome_1mbp):
    """extract_minimizers at the library search's k 15, window 10, one
    sequence padded to 128, as find_repeats_by_library calls it."""
    _, segments = repeat_genome_1mbp
    for seg in segments[:3]:
        mat, lengths, _ = jseq.pack_reads([seg], pad_multiple=128)
        j = jmin.extract_minimizers(mat, lengths, 15, 10)
        t = tmin.extract_minimizers(torch.from_numpy(mat), torch.from_numpy(lengths), 15, 10)
        for a, b, name in zip(t, j, ("kcodes", "sel", "valid")):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert t[1].sum() > len(seg) // 10
