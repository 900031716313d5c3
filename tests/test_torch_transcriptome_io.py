"""The port's transcriptome model and formats against the JAX package on the
CPU: the four modules GenomesAligner needs (ROADMAP.md item 17e), copied
whole for item 17f.

The cases of tests/test_transcriptome_io.py (GTF2, UCSC and CCDS readers,
the GFF3 writer and reader, the annotation combiner) run through both
packages; each loaded transcriptome (genes, transcripts, segments) is held
equal to the JAX package's field by field, and the GFF3 writer's lines
equal but for the source column (each package names itself there)."""
import pytest

import ngsepcore_tpu.transcriptome.io_formats as jfmt
import ngsepcore_tpu.transcriptome.model as jmodel
import ngsepcore_tpu.transcriptome.protein as jprot
import ngsepcore_tpu_torch.transcriptome.io_formats as tfmt
import ngsepcore_tpu_torch.transcriptome.model as tmodel
import ngsepcore_tpu_torch.transcriptome.protein as tprot

GTF = ('chr1\tsrc\ttranscript\t100\t500\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
       'chr1\tsrc\texon\t100\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
       'chr1\tsrc\tCDS\t150\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
       'chr1\tsrc\texon\t300\t500\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n')
GTF_MINUS = ('chr1\tsrc\ttranscript\t700\t900\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
             'chr1\tsrc\texon\t700\t900\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n')
UCSC = "t1\tchr1\t+\t99\t500\t149\t400\t2\t99,299,\t200,500,\tGENE1\n"
CCDS = ("#chromosome\tnc\tgene\tgene_id\tccds_id\tstatus\tstrand\tfrom\tto\tlocations\tmatch\n"
        "1\tNC_1\tGENE1\tg1\tCCDS1.1\tPublic\t+\t99\t499\t[99-199, 299-499]\tIdentical\n"
        "1\tNC_1\tGENE2\tg2\tCCDS2.1\tWithdrawn\t+\t99\t499\t[99-199]\tIdentical\n")


def _state(x):
    if isinstance(x, dict):
        return {k: _state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_state(v) for v in x]
    if hasattr(x, "__dict__"):
        return (type(x).__name__, _state(vars(x)))
    return x


def _gff_rows(path):
    with open(path) as fh:
        return [l.split("\t")[:1] + l.split("\t")[2:] for l in fh]


def _load(fmt, case, d):
    """Transcriptome of `case` loaded with one package's formats module."""
    if case == "gtf2":
        (d / "x.gtf").write_text(GTF)
        return fmt.load_transcriptome_gtf2(str(d / "x.gtf"))
    if case == "ucsc":
        (d / "x.txt").write_text(UCSC)
        return fmt.load_transcriptome_ucsc(str(d / "x.txt"))
    if case == "ccds":
        (d / "ccds.txt").write_text(CCDS)
        return fmt.load_transcriptome_ccds(str(d / "ccds.txt"))
    if case == "gff3_roundtrip":
        (d / "x.gtf").write_text(GTF)
        fmt.write_transcriptome_gff3(fmt.load_transcriptome_gtf2(str(d / "x.gtf")),
                                     str(d / "x.gff3"))
        return fmt.load_transcriptome(str(d / "x.gff3"))
    (d / "a.gtf").write_text(GTF)
    (d / "b.gtf").write_text(GTF_MINUS)
    return fmt.combine_annotations(fmt.load_transcriptome_gtf2(str(d / "a.gtf")),
                                   fmt.load_transcriptome_gtf2(str(d / "b.gtf")))


@pytest.mark.parametrize("case", ["gtf2", "ucsc", "ccds", "gff3_roundtrip", "combine"])
def test_transcriptome_formats_equal_jax(case, tmp_path):
    got = {}
    for tag, fmt in (("j", jfmt), ("t", tfmt)):
        d = tmp_path / tag
        d.mkdir()
        got[tag] = _load(fmt, case, d)
    t = got["t"]
    assert _state(t.genes) == _state(got["j"].genes)
    assert _state(t.transcripts) == _state(got["j"].transcripts)
    coding = [s for tr in t.transcripts.values() for s in tr.segments
              if s.status == tmodel.CODING]
    if case == "gtf2":
        assert t.transcripts["t1"].first == 100 and coding[0].first == 150
    elif case == "ucsc":
        assert t.transcripts["t1"].gene_id == "GENE1" and coding[0].first == 150
    elif case == "ccds":
        assert set(t.transcripts) == {"CCDS1.1"}
        assert t.transcripts["CCDS1.1"].sequence_name == "chr1"
    elif case == "gff3_roundtrip":
        assert t.transcripts["t1"].coding
        assert _gff_rows(tmp_path / "t" / "x.gff3") == _gff_rows(tmp_path / "j" / "x.gff3")
    else:
        assert set(t.transcripts) == {"t1", "t2"}


def test_protein_translation_equal_jax():
    dna = "ATGGCCATTGTAATGGGCCGCTGAAAGGGTGCCCGATAGNNATGC"
    for frame in range(3):
        assert tprot.ProteinTranslator().translate(dna[frame:]) == \
            jprot.ProteinTranslator().translate(dna[frame:])
    assert tprot.ProteinTranslator().translate("ATGGCCTAA").startswith("MA")
    assert tmodel.UTR5 == jmodel.UTR5 and tmodel.CODING == jmodel.CODING
