"""The port's variant annotator, transcriptome tools and codon alignment
against the JAX package on the CPU (ROADMAP.md item 17f).

The cases of tests/test_annotator.py and the transcriptome and codon cases
of tests/test_long_tail.py run through both packages: SO terms, transcript
and gene ids, codon numbers and amino-acid changes must be equal, and the
port's must also pass those files' own checks.  All values are exact."""
import numpy as np
import pytest

import ngsepcore_tpu.core.genome as jgen
import ngsepcore_tpu.core.sequences as jseq
import ngsepcore_tpu.transcriptome.annotator as jann
import ngsepcore_tpu.transcriptome.codon_alignment as jcod
import ngsepcore_tpu.transcriptome.gff3 as jgff
import ngsepcore_tpu.transcriptome.protein as jprot
import ngsepcore_tpu.transcriptome.tools as jtools
import ngsepcore_tpu.variants.model as jvar
import ngsepcore_tpu_torch.core.genome as tgen
import ngsepcore_tpu_torch.core.sequences as tseq
import ngsepcore_tpu_torch.transcriptome.annotator as tann
import ngsepcore_tpu_torch.transcriptome.codon_alignment as tcod
import ngsepcore_tpu_torch.transcriptome.gff3 as tgff
import ngsepcore_tpu_torch.transcriptome.protein as tprot
import ngsepcore_tpu_torch.transcriptome.tools as ttools
import ngsepcore_tpu_torch.variants.model as tvar

PKGS = {
    "j": (jgen, jseq, jann, jgff, jvar, jtools),
    "t": (tgen, tseq, tann, tgff, tvar, ttools),
}
GFF = ("##gff-version 3\n"
       "chr1\ttest\tgene\t1001\t1300\t.\t+\t.\tID=gene1;Name=G1\n"
       "chr1\ttest\tmRNA\t1001\t1300\t.\t+\t.\tID=t1;Parent=gene1\n"
       "chr1\ttest\tCDS\t1001\t1100\t.\t+\t0\tID=c1;Parent=t1\n"
       "chr1\ttest\tCDS\t1201\t1300\t.\t+\t1\tID=c2;Parent=t1\n")


def _fields(a):
    return (a.annotation, a.transcript_id, a.gene_id, a.codon, a.aa_change)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """test_annotator's genome (3,000 bp, a two-exon gene on the + strand
    from 1,001) and an annotator of each package."""
    rng = np.random.default_rng(30)
    seq = list("".join(rng.choice(list("ACGT"), size=3000)))
    seq[1000:1003] = list("ATG")
    seq = "".join(seq)
    gff = tmp_path_factory.mktemp("gff") / "genes.gff3"
    gff.write_text(GFF)
    ann = {}
    for tag, (gen, sq, an, gf, _, _) in PKGS.items():
        genome = gen.ReferenceGenome(
            sq.QualifiedSequenceList([sq.QualifiedSequence.from_string("chr1", seq)]))
        ann[tag] = an.VariantFunctionalAnnotator(genome, gf.load_transcriptome_gff3(str(gff)))
    return seq, ann


def _annotate(setup, pos, alleles):
    """The port's annotation of a variant, after holding it equal to the
    JAX package's."""
    _, ann = setup
    got = {tag: ann[tag].annotate(PKGS[tag][4].GenomicVariant("chr1", pos, alleles))
           for tag in ann}
    assert _fields(got["t"]) == _fields(got["j"])
    return got["t"]


def _alt(base):
    return "A" if base != "A" else "C"


def test_protein_translator():
    for prot in (jprot, tprot):
        t = prot.ProteinTranslator()
        assert t.translate("ATGGCTTAA") == "MA"
        assert t.translate_codon("TGG") == "W"
        assert t.is_stop("TAG")
        assert t.translate("ATGAAACCC", trim_at_stop=False) == "MKP"


def test_intergenic(setup):
    seq, _ = setup
    assert _annotate(setup, 2900, [seq[2899], _alt(seq[2899])]).annotation == \
        "intergenic_variant"


def test_upstream_downstream(setup):
    seq, _ = setup
    assert _annotate(setup, 500, [seq[499], _alt(seq[499])]).annotation == \
        "upstream_transcript_variant"
    assert _annotate(setup, 1450, [seq[1449], _alt(seq[1449])]).annotation == \
        "downstream_transcript_variant"


def test_intron_and_splice(setup):
    seq, _ = setup
    for pos, want in ((1101, "splice_donor_variant"), (1200, "splice_acceptor_variant"),
                      (1150, "intron_variant"), (1105, "splice_region_variant")):
        assert _annotate(setup, pos, [seq[pos - 1], _alt(seq[pos - 1])]).annotation == want


def test_start_lost(setup):
    a = _annotate(setup, 1001, ["A", "G"])
    assert a.annotation == "start_lost" and a.aa_change == "M1V"


def test_synonymous_and_missense(setup):
    seq, _ = setup
    tr = tprot.ProteinTranslator()
    found_syn = found_mis = None
    for ci in range(1, 33):
        codon = seq[1000 + 3 * ci : 1003 + 3 * ci]
        for alt in "ACGT":
            if alt == codon[2]:
                continue
            new = codon[:2] + alt
            if tr.translate_codon(new) == tr.translate_codon(codon) and found_syn is None:
                found_syn = (1003 + 3 * ci, codon[2], alt)
            ref_aa, alt_aa = tr.translate_codon(codon), tr.translate_codon(new)
            if alt_aa not in (ref_aa, "*") and ref_aa != "*" and found_mis is None:
                found_mis = (1003 + 3 * ci, codon[2], alt)
    pos, ref, alt = found_syn
    assert _annotate(setup, pos, [ref, alt]).annotation == "synonymous_variant"
    pos, ref, alt = found_mis
    a = _annotate(setup, pos, [ref, alt])
    assert a.annotation == "missense_variant" and a.aa_change is not None


def test_frameshift_and_inframe(setup):
    seq, _ = setup
    assert _annotate(setup, 1050, [seq[1049] + seq[1050], seq[1049]]).annotation == \
        "frameshift_variant"
    assert _annotate(setup, 1050, [seq[1049:1053], seq[1049]]).annotation == \
        "inframe_deletion"


def test_every_position_of_the_genome_equal_jax(setup):
    """Each position of the 3 kb genome with each other base, and 1-4 base
    indels every 7 bp: the same annotation (term, ids, codon, change)."""
    seq, ann = setup
    n = 0
    for pos in range(1, 3001):
        for alt in "ACGT":
            if alt != seq[pos - 1]:
                _annotate(setup, pos, [seq[pos - 1], alt])
                n += 1
        if pos % 7 == 0 and pos < 2996:
            k = pos % 4 + 1
            _annotate(setup, pos, [seq[pos - 1 : pos + k], seq[pos - 1]])
            _annotate(setup, pos, [seq[pos - 1], seq[pos - 1] + "A" * k])
    assert n == 9000


def test_transcriptome_filter_roundtrip(tmp_path):
    text = ("##gff-version 3\n"
            "chr1\tx\tgene\t100\t900\t.\t+\t.\tID=gene1\n"
            "chr1\tx\tmRNA\t100\t900\t.\t+\t.\tID=t1;Parent=gene1\n"
            "chr1\tx\tCDS\t100\t400\t.\t+\t0\tID=c1;Parent=t1\n"
            "chr1\tx\tmRNA\t2000\t2100\t.\t-\t.\tID=t2;Parent=gene2\n"
            "chr1\tx\texon\t2000\t2100\t.\t-\t.\tParent=t2\n")
    (tmp_path / "in.gff3").write_text(text)
    out = {}
    for tag, (_, _, _, gf, _, tools) in PKGS.items():
        t = gf.load_transcriptome_gff3(str(tmp_path / "in.gff3"))
        f = tools.filter_transcriptome(t, only_coding=True)
        assert "t1" in f.transcripts and "t2" not in f.transcripts
        path = tmp_path / f"out_{tag}.gff3"
        tools.write_transcriptome_gff3(f, str(path))
        assert "t1" in gf.load_transcriptome_gff3(str(path)).transcripts
        out[tag] = path.read_text()
        kept = tools.filter_transcriptome(t, min_length=200, gene_ids={"gene2"})
        assert set(kept.transcripts) == set()
        from ngsepcore_tpu_torch.core.regions import GenomicRegion

        regions = [GenomicRegion("chr1", 1950, 2050)]
        assert set(tools.filter_transcriptome(t, regions=regions).transcripts) == {"t2"}
    assert out["t"] == out["j"]


def test_mutated_peptides(tmp_path):
    seq = "ATGAAACCCGGGTTTACGGATCATTAGAAA"
    (tmp_path / "g.gff3").write_text(
        "##gff-version 3\nchr1\tx\tgene\t1\t27\t.\t+\t.\tID=g1\n"
        "chr1\tx\tmRNA\t1\t27\t.\t+\t.\tID=t1;Parent=g1\n"
        "chr1\tx\tCDS\t1\t27\t.\t+\t0\tParent=t1\n")
    got = {}
    for tag, (gen, sq, _, gf, var, tools) in PKGS.items():
        g = gen.ReferenceGenome(
            sq.QualifiedSequenceList([sq.QualifiedSequence.from_string("chr1", seq)]))
        t = gf.load_transcriptome_gff3(str(tmp_path / "g.gff3"))
        variants = [var.GenomicVariant("chr1", 4, ["A", "C"]),
                    var.GenomicVariant("chr1", 9, ["C", "A"]),
                    var.GenomicVariant("chr1", 12, ["G", "A"])]
        got[tag] = [vars(p) for p in tools.extract_mutated_peptides(g, t, variants)]
    assert got["t"] == got["j"]
    assert got["t"][0]["aa_change"] == "K2Q" and "Q" in got["t"][0]["peptide"]


@pytest.mark.parametrize("pair", [
    ("ATGAAACCC", "ATGAAACCC"),
    ("ATGCCCTTTGGG", "ATGCCCAAATTTGGG"),
    ("ATGAAATTT", "ATGCCCTTT"),
    ("", "ATG"),
    ("random", None),
])
def test_codon_cds_pairwise_alignment(pair):
    """CodonCDSPairwiseAlignment: test_long_tail's three cases, an empty
    CDS and 20 random pairs with codon indels; every field equal."""
    if pair[0] == "random":
        rng = np.random.default_rng(8)
        pairs = []
        for _ in range(20):
            a = "".join(rng.choice(list("ACGT"), size=3 * int(rng.integers(5, 40))))
            b = list(a[i : i + 3] for i in range(0, len(a), 3))
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, len(b)))
                if rng.random() < 0.5:
                    del b[p]
                else:
                    b.insert(p, "".join(rng.choice(list("ACGT"), size=3)))
            pairs.append((a, "".join(b) + "AC"))
    else:
        pairs = [pair]
    for a, b in pairs:
        out = []
        for mod in (jcod, tcod):
            al = mod.CodonCDSPairwiseAlignment()
            al.calculate_alignment(a, b)
            out.append((al.get_alignment1(), al.get_alignment2(), al.get_score(),
                        al.get_pct_identity()))
        assert out[1] == out[0]
    if pair == ("ATGCCCTTTGGG", "ATGCCCAAATTTGGG"):
        assert out[1][:3] == ("ATGCCC---TTTGGG", "ATGCCCAAATTTGGG", 2)
