"""Command implementations wired into the registry.

Command ids, groups, flags and former ids are those of
ngsepcore_tpu/cli/commands.py (the reference's CommandsDescriptor.xml).
Three commands are ported: GenomeIndexer, ReadsAligner (short reads) and
SingleSampleVariantsDetector.  Every other id is registered as pending:
running it exits with an error naming the ROADMAP.md item that ports it.
Runners take the device the CLI's --device flag names.
"""
from __future__ import annotations

import sys

from .registry import Command, Option, register


# ---- Reads group ---------------------------------------------------------

def _run_genome_indexer(opts: dict, args: list[str], device) -> None:
    from ..core.genome import ReferenceGenome
    from ..index.minimizer_table import MinimizerTable

    if not args:
        raise SystemExit("Usage: GenomeIndexer <genome.fa> [-o outprefix]")
    genome = ReferenceGenome.load(args[0])
    out = opts.pop("output_prefix", None) or args[0]
    t = MinimizerTable.build_from_genome(genome, **opts, device=device)
    t.save(out + "_minimizers.npz")
    print(f"Indexed {genome.total_length} bp; {t.size} minimizer entries")


register(
    Command(
        id="GenomeIndexer",
        group="Reads",
        description="Builds and saves the minimizer seed index of a genome",
        runner=_run_genome_indexer,
        options=[
            Option("k", "k", "int", 25, "K-mer length"),
            Option("w", "window", "int", 20, "Minimizer window"),
            Option("o", "output_prefix", "str", None, "Output prefix"),
        ],
    )
)


def _run_reads_aligner(opts: dict, args: list[str], device) -> None:
    from ..align.reads_aligner import ReadsAligner
    from ..core.genome import ReferenceGenome
    from ..io.fastq import FastqFileReader
    from ..io.sam import ReadAlignmentFileWriter
    from ..utils.profiling import stage

    genome_path = opts.pop("genome", None)
    out = opts.pop("output_file", None)
    sample = opts.pop("sample_id", None) or "Sample"
    if not genome_path or not args:
        raise SystemExit("Usage: ReadsAligner -r <genome.fa> -o <out.sam> <reads.fastq>")
    platform = (opts.pop("platform", None) or "ILLUMINA").upper()
    if platform in ("PACBIO", "ONT"):
        raise SystemExit(
            f"ReadsAligner -p {platform} (the long-read aligner) is not "
            "ported yet: ROADMAP.md Queue 1 item 12"
        )
    paired = bool(opts.pop("paired", False)) or len(args) == 2
    with stage("cli.load_genome"):
        genome = ReferenceGenome.load(genome_path)
    with stage("cli.index"):
        aligner = ReadsAligner(genome, **opts, device=device)
    n_out = 0
    # the batch size of the JAX CLI: one seed-result fetch per 4096 reads
    batch = 4096
    with ReadAlignmentFileWriter(genome.sequences, out or "-", sample_id=sample) as w:
        if paired and len(args) == 2:
            from ..align.paired import PairedReadsAligner

            pa = PairedReadsAligner(aligner)
            it1 = FastqFileReader(args[0]).iter_batches(batch)
            it2 = FastqFileReader(args[1]).iter_batches(batch)
            for b1, b2 in zip(it1, it2):
                for alns in pa.align_batch(b1, b2):
                    for a in alns:
                        w.write(a)
                        n_out += 1
            print(f"Proper pairs: {pa.proper_pairs}/{pa.pairs}", file=sys.stderr)
        else:
            for path in args:
                batches = FastqFileReader(path).iter_batches(batch)
                while True:
                    with stage("cli.read_fastq"):
                        reads = next(batches, None)
                    if reads is None:
                        break
                    with stage("cli.align_batch"):
                        results = aligner.align_batch(reads)
                    with stage("cli.write"):
                        for alns in results:
                            for a in alns:
                                w.write(a)
                                n_out += 1
    print(
        f"Reads: {aligner.total_reads} Aligned: {aligner.aligned_reads} "
        f"records: {n_out}",
        file=sys.stderr,
    )


register(
    Command(
        id="ReadsAligner",
        group="Reads",
        description="Aligns reads to a reference genome",
        runner=_run_reads_aligner,
        options=[
            Option("r", "genome", "str", None, "Reference genome FASTA"),
            Option("o", "output_file", "str", None, "Output SAM file"),
            Option("s", "sample_id", "str", None, "Sample id for read group"),
            Option("k", "kmer_length", "int", 25, "Seed k-mer length"),
            Option("w", "window_length", "int", 20, "Minimizer window"),
            Option("a", "max_alns_per_read", "int", 1, "Max alignments per read"),
            Option("p", "platform", "str", "ILLUMINA",
                   "Platform: ILLUMINA, IONTORRENT (PACBIO, ONT: not ported)"),
            Option("paired", "paired", "bool", False, "Paired-end (two fastq files)"),
        ],
    )
)


# ---- Discovery group -----------------------------------------------------

def _run_single_sample_detector(opts: dict, args: list[str], device) -> None:
    from ..call.single_sample import SingleSampleVariantsDetector
    from ..core.genome import ReferenceGenome
    from ..utils.profiling import stage

    genome_path = opts.pop("genome", None)
    inp = opts.pop("input_file", None) or (args[0] if args else None)
    out = opts.pop("output_prefix", None)
    if not genome_path or not inp or not out:
        raise SystemExit(
            "Usage: SingleSampleVariantsDetector -r <genome.fa> -i <alns.sam> -o <prefix>"
        )
    with stage("cli.load_genome"):
        genome = ReferenceGenome.load(genome_path)
    det = SingleSampleVariantsDetector(genome, **opts, device=device)
    n = det.run(inp, out + ".vcf")
    print(f"Called {n} variants -> {out}.vcf", file=sys.stderr)


register(
    Command(
        id="SingleSampleVariantsDetector",
        former_id="FindVariants",
        group="Discovery",
        description="Detects and genotypes variants in alignments of one sample",
        runner=_run_single_sample_detector,
        options=[
            Option("r", "genome", "str", None, "Reference genome FASTA"),
            Option("i", "input_file", "str", None, "Input SAM file"),
            Option("o", "output_prefix", "str", None, "Output prefix"),
            Option("sampleId", "sample_id", "str", "Sample", "Sample id"),
            Option("h", "heterozygosity_rate", "float", 0.001, "Heterozygosity rate"),
            Option("minQuality", "min_quality", "int", 40, "Min genotype quality"),
            Option("minMQ", "min_mq", "int", 20, "Min mapping quality"),
            Option("ploidy", "ploidy", "int", 2, "Sample ploidy"),
            Option("cnvs", "find_cnvs", "bool", False,
                   "Read-depth CNV detection (not ported)"),
            Option("algCNV", "alg_cnv", "str", "CNVnator",
                   "Comma-separated CNV algorithms (with -cnvs)"),
            Option("svs", "find_svs", "bool", False,
                   "Read-pair SV detection (not ported)"),
            Option("runLongReadSVs", "run_long_read_svs", "bool", False,
                   "Long-read SV detection (not ported)"),
            Option("minSVQuality", "min_sv_quality", "int", 0,
                   "Min genotype quality for SV calls"),
            Option("knownSTRs", "known_strs_file", "str", None,
                   "Known STRs file (not ported)"),
            Option("querySeq", "query_seq", "str", None,
                   "Restrict calling to this sequence (indexed BAM reads)"),
            Option("first", "query_first", "int", 0,
                   "Region start (1-based, with -querySeq)"),
            Option("last", "query_last", "int", 0,
                   "Region end (inclusive, with -querySeq)"),
            Option("noRep", "find_repeats", "bool", False,
                   "Find repeats from multi-mapping reads and mask calls in them"),
            Option("knownRepeats", "known_repeats_file", "str", None,
                   "Known repeats file; calls inside repeats are masked"),
        ],
    )
)


# ---- command ids not ported yet -----------------------------------------

_K_MERS = "ROADMAP.md Queue 1 item 10 (k-mers)"
_DEPTH = "ROADMAP.md Queue 1 item 11 (multisample and read-depth stages)"
_ASSEMBLY = "ROADMAP.md Queue 1 item 13 (assembly)"
_HMM = "ROADMAP.md Queue 1 item 14 (HMM consumers)"
_TAIL = "ROADMAP.md Queue 1 item 17 (the long tail)"

# id -> (group, description, former id, hidden, ROADMAP item)
_PENDING: dict[str, tuple[str, str, str | None, bool, str]] = {
    "KmersExtractor": ("Reads", "Counts k-mers from sequencing reads or assembled sequences", "KmersCounter", False, _K_MERS),
    "Assembler": ("Reads", "De-novo long-read assembly (minimizer overlap graph)", None, False, _ASSEMBLY),
    "ReadsFileErrorsCorrector": ("Reads", "K-mer spectrum read error correction", None, False, _K_MERS),
    "TillingIndividualVCF2PoolVCF": ("Benchmark", "Convert an individuals VCF to the pooled-sample VCF a TILLING run would produce", None, False, _TAIL),
    "Demultiplex": ("Reads", "Demultiplexes pooled reads by barcodes", None, False, _TAIL),
    "IndividualGenomeBuilder": ("Reads", "Applies VCF variants to a genome FASTA", None, False, _TAIL),
    "GenomeAssemblyMask": ("Genomes", "Masks genome regions with N", None, False, _TAIL),
    "MultisampleVariantsDetector": ("Discovery", "Joint population variant calling from multiple samples", None, False, _DEPTH),
    "ReadDepthComparator": ("Discovery", "Case-control read-depth CNV detection (CNV-seq)", "CompareRD", False, _DEPTH),
    "CoverageStats": ("Discovery", "Coverage uniformity statistics from alignments", None, False, _DEPTH),
    "BasePairQualStats": ("Discovery", "Per-read-position mismatch rates vs the genome", "QualStats", False, _TAIL),
    "SingleReadsSimulator": ("Benchmark", "Simulates sequencing reads from a genome", None, False, _TAIL),
    "SingleIndividualSimulator": ("Benchmark", "Simulates a mutated individual genome with truth VCF", None, False, _TAIL),
    "VCFImpute": ("VariantsDownstream", "Imputes missing genotypes with a haplotype-cluster HMM", "ImputeVCF", False, _HMM),
    "SIH": ("Discovery", "Single individual haplotyping (RefHap-style MEC search)", None, False, _HMM),
    "VCFGoldStandardComparator": ("Benchmark", "Genotype-aware TP/FP/FN vs a gold standard per quality bin", None, False, _TAIL),
    "VCFAnnotate": ("VariantsDownstream", "Functional annotation of variants vs gene models (SO terms)", "Annotate", False, _TAIL),
    "GenomesAligner": ("Genomes", "Whole-genome ortholog and synteny comparison", None, False, _TAIL),
    "CDNACatalogAligner": ("Genomes", "Orthogroups from cDNA/protein catalogs", None, False, _TAIL),
    "TranscriptomeAnalyzer": ("Genomes", "Gene-model statistics from a GFF3", None, False, _TAIL),
    "VCFFilter": ("VariantsDownstream", "Filters VCF sites and genotypes", "FilterVCF", False, _TAIL),
    "VCFSummaryStats": ("VariantsDownstream", "Variant count reports by category", "SummaryStats", False, _TAIL),
    "VCFDiversityStats": ("VariantsDownstream", "Per-site diversity statistics (MAF, heterozygosity, F)", "DiversityStats", False, _TAIL),
    "VCFVariantDensityCalculator": ("VariantsDownstream", "Variant density in genome windows", None, False, _TAIL),
    "VCFDistanceMatrixCalculator": ("VariantsDownstream", "Genetic distance matrix from genotype calls", None, False, _TAIL),
    "NeighborJoining": ("VariantsDownstream", "Neighbor-joining dendrogram from a distance matrix", None, False, _TAIL),
    "DistanceClusteringService": ("VariantsDownstream", "Tree building from a distance matrix (NJ or UPGMA)", None, True, _TAIL),
    "VCFComparator": ("VariantsDownstream", "Genotype concordance between two VCFs", "CompareVCF", False, _TAIL),
    "VCFConverter": ("VariantsDownstream", "Exports genotypes to population-genetics formats", "ConvertVCF", False, _TAIL),
    "VCFMerge": ("Discovery", "Merges per-sample VCFs into a population VCF", "MergeVCF", False, _TAIL),
    "DeNovoGBS": ("Reads", "De-novo GBS read clustering and variant calling", None, False, _TAIL),
    "TransposonsFinder": ("Genomes", "Transposable element / repeat annotation", None, False, _TAIL),
    "MergeVariants": ("Discovery", "Merges variant site lists across samples (no genotypes)", None, False, _TAIL),
    "RelativeAlleleCountsCalculator": ("Discovery", "Relative allele-count distribution (ploidy/contamination QC)", "RelativeAlleleCounts", False, _TAIL),
    "VCFAlleleSharingStats": ("VariantsDownstream", "Window allele-sharing diversity between sample groups", "AlleleSharingStats", False, _TAIL),
    "VCFIntrogressionAnalysis": ("VariantsDownstream", "Window-based haplotype introgression detection", "IntrogressionAnalysis", False, _TAIL),
    "TranscriptomeFilter": ("Genomes", "Filters gene annotations", None, False, _TAIL),
    "MutatedPeptidesExtractor": ("VariantsDownstream", "Mutated peptides from missense variants + gene models", None, True, _TAIL),
    "VCFRelativeCoordinatesTranslator": ("VariantsDownstream", "Maps de-novo GBS cluster variants to reference coordinates", None, False, _TAIL),
    "UneakToVCFConverter": ("VariantsDownstream", "Converts UNEAK HapMap+consensus output to VCF", None, True, _TAIL),
    "TillingPopulationSimulator": ("Benchmark", "Simulates a TILLING population arranged in pools", None, False, _TAIL),
    "TillingPoolsIndividualGenotyper": ("Discovery", "Assigns pooled TILLING variants to individuals", None, False, _TAIL),
    "AssemblyGraphStatistics": ("Reads", "Assembly statistics (N50, totals, truth comparison)", None, True, _ASSEMBLY),
}


for _cid, (_grp, _desc, _former, _hidden, _item) in _PENDING.items():
    register(
        Command(
            id=_cid, group=_grp, description=_desc, runner=None,
            former_id=_former, hidden=_hidden, pending=_item,
        )
    )
