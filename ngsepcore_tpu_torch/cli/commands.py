"""Command implementations wired into the registry.

Command ids, groups, flags and former ids are those of
ngsepcore_tpu/cli/commands.py (the reference's CommandsDescriptor.xml).
Twelve commands are ported: KmersExtractor, GenomeIndexer, ReadsAligner
(short and long reads), ReadsFileErrorsCorrector, Assembler,
AssemblyGraphStatistics, SingleSampleVariantsDetector, SIH,
MultisampleVariantsDetector, ReadDepthComparator, CoverageStats and
BasePairQualStats.  Every other id is registered as pending:
running it exits with an error naming the ROADMAP.md item that ports it.
Runners take the device the CLI's --device flag names.
"""
from __future__ import annotations

import sys

from .registry import Command, Option, register


# ---- Reads group ---------------------------------------------------------

def _run_kmers_extractor(opts: dict, args: list[str], device) -> None:
    from ..index.kmers_extractor import KmersExtractor

    out = opts.pop("output_prefix", None) or (args[0] + "_out" if args else "kmers")
    text = opts.pop("text_output", False)
    ex = KmersExtractor(**opts, device=device)
    ex.run(args, out, text_output=bool(text))
    print(f"Processed {len(args)} file(s); distinct {ex.kmers_map.size} kmers")


register(
    Command(
        id="KmersExtractor",
        former_id="KmersCounter",
        group="Reads",
        description="Counts k-mers from sequencing reads or assembled sequences",
        runner=_run_kmers_extractor,
        options=[
            Option("k", "kmer_length", "int", 15, "K-mer length (default 15)"),
            Option("m", "min_kmer_count", "int", 5, "Minimum count to report"),
            Option("s", "only_forward_strand", "bool", False, "Only forward strand"),
            Option("o", "output_prefix", "str", None, "Output prefix"),
            Option("t", "text_output", "bool", False, "Write kmers as text"),
        ],
    )
)


def _run_assembler(opts: dict, args: list[str], device) -> None:
    from ..assembly.assembler import Assembler, n_statistics
    from ..io.fasta import FastaFileReader, save_fasta
    from ..io.fastq import FastqFileReader

    if len(args) < 2:
        raise SystemExit("Usage: Assembler <reads.fastq|fa> <out_prefix>")
    path = args[0]
    if path.lower().endswith((".fastq", ".fq", ".fastq.gz", ".fq.gz")):
        reads = [r.codes for r in FastqFileReader(path)]
    else:
        reads = [s.codes for s in FastaFileReader(path)]
    asm = Assembler(**opts, device=device)
    contigs = asm.assemble(reads)
    save_fasta(contigs, args[1] + "_contigs.fa")
    stats = n_statistics([len(c) for c in contigs])
    print(
        f"Assembled {stats['count']} contigs, total {stats['total']} bp, "
        f"N50 {stats.get('N50', 0)}, max {stats['max']}",
        file=sys.stderr,
    )


register(
    Command(
        id="Assembler",
        group="Reads",
        description="De-novo long-read assembly (minimizer overlap graph)",
        runner=_run_assembler,
        options=[
            Option("k", "kmer_length", "int", 15, "K-mer length"),
            Option("w", "window_length", "int", 10, "Minimizer window"),
            Option("m", "min_shared_minimizers", "int", 6, "Min shared minimizers"),
            Option("l", "min_overlap", "int", 200, "Minimum overlap length"),
            Option("polish", "polish_rounds", "int", 1,
                   "Consensus polishing rounds (0 = off)"),
            Option("circular", "circular", "bool", False,
                   "Detect and trim circular contigs"),
            Option("ploidy", "ploidy", "int", 1,
                   "Sample ploidy (2 = phased diploid assembly)"),
        ],
    )
)


def _run_assembly_graph_stats(opts: dict, args: list[str], device) -> None:
    from ..assembly.assembler import n_statistics
    from ..io.fasta import load_fasta

    if not args:
        raise SystemExit("Usage: AssemblyGraphStatistics <contigs.fa> [truth.fa]")
    contigs = load_fasta(args[0])
    stats = n_statistics([len(c) for c in contigs])
    print(f"Contigs\t{stats['count']}")
    print(f"Total\t{stats['total']}")
    print(f"Max\t{stats['max']}")
    print(f"N50\t{stats.get('N50', 0)}")
    if len(args) > 1:
        truth = load_fasta(args[1])
        truth_len = sum(len(t) for t in truth)
        print(f"TruthLength\t{truth_len}")
        print(f"TotalVsTruth\t{stats['total'] / max(1, truth_len):.3f}")


register(
    Command(
        id="AssemblyGraphStatistics",
        group="Reads",
        description="Assembly statistics (N50, totals, truth comparison)",
        runner=_run_assembly_graph_stats,
        hidden=True,
        options=[],
    )
)


def _run_errors_corrector(opts: dict, args: list[str], device) -> None:
    from ..index.error_correction import ReadsFileErrorsCorrector

    if len(args) < 2:
        raise SystemExit("Usage: ReadsFileErrorsCorrector <in.fastq> <out.fastq>")
    c = ReadsFileErrorsCorrector(**opts, device=device)
    c.run(args[0], args[1])
    print(
        f"Corrected {c.corrected_errors} errors in {c.corrected_reads} reads",
        file=sys.stderr,
    )


register(
    Command(
        id="ReadsFileErrorsCorrector",
        group="Reads",
        description="K-mer spectrum read error correction",
        runner=_run_errors_corrector,
        options=[
            Option("k", "kmer_length", "int", 15, "K-mer length"),
            Option("m", "min_kmer_count", "int", 5, "Min k-mer count"),
            Option(
                "a", "algorithm", "str", "debruijn",
                "Correction algorithm: debruijn (k-mer-graph walks, fixes"
                " indels; reference default) or snp",
            ),
        ],
    )
)


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
    paired = bool(opts.pop("paired", False)) or len(args) == 2
    with stage("cli.load_genome"):
        genome = ReferenceGenome.load(genome_path)
    with stage("cli.index"):
        if platform in ("PACBIO", "ONT"):
            from ..align.long_reads import LongReadsAligner

            aligner = LongReadsAligner(genome, **opts, device=device)
            paired = False
        else:
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
                   "Platform: ILLUMINA, IONTORRENT, PACBIO, ONT"),
            Option("paired", "paired", "bool", False, "Paired-end (two fastq files)"),
        ],
    )
)


# ---- Discovery group -----------------------------------------------------

def _run_multisample_detector(opts: dict, args: list[str], device) -> None:
    from ..call.multisample import MultisampleVariantsDetector
    from ..core.genome import ReferenceGenome
    from ..utils.profiling import stage

    genome_path = opts.pop("genome", None)
    out = opts.pop("output_file", None)
    if not genome_path or not out or not args:
        raise SystemExit(
            "Usage: MultisampleVariantsDetector -r <genome.fa> -o <out.vcf> <s1.sam> <s2.sam> ..."
        )
    with stage("cli.load_genome"):
        genome = ReferenceGenome.load(genome_path)
    det = MultisampleVariantsDetector(genome, **opts, device=device)
    n = det.run(args, out)
    print(f"Called {n} population variants -> {out}", file=sys.stderr)


register(
    Command(
        id="MultisampleVariantsDetector",
        group="Discovery",
        description="Joint population variant calling from multiple samples",
        runner=_run_multisample_detector,
        options=[
            Option("r", "genome", "str", None, "Reference genome FASTA"),
            Option("o", "output_file", "str", None, "Output VCF"),
            Option("h", "heterozygosity_rate", "float", 0.001, "Heterozygosity rate"),
            Option("minQuality", "min_quality", "int", 40, "Min variant quality"),
            Option("minMQ", "min_mq", "int", 20, "Min mapping quality"),
            Option("ploidy", "ploidy", "int", 2, "Sample ploidy"),
        ],
    )
)


def _write_report(out: str | None, write) -> None:
    """Call write(fh) on the output file, or on stdout without one."""
    if out:
        with open(out, "w") as fh:
            write(fh)
    else:
        write(sys.stdout)


# The three commands below are host numpy in the JAX package too: they take
# the CLI's device like every runner and start nothing on it.

def _run_read_depth_comparator(opts: dict, args: list[str], device) -> None:
    from ..call.read_depth import cnv_seq_compare
    from ..core.genome import ReferenceGenome
    from ..io.sam import ReadAlignmentFileReader

    genome_path = opts.pop("genome", None)
    out = opts.pop("output_file", None)
    if not genome_path or len(args) < 2:
        raise SystemExit(
            "Usage: ReadDepthComparator -r <genome.fa> <case.sam> <control.sam> [-o out]"
        )
    genome = ReferenceGenome.load(genome_path)
    case = list(ReadAlignmentFileReader(args[0]))
    control = list(ReadAlignmentFileReader(args[1]))
    cnvs = cnv_seq_compare(genome, case, control, **opts)

    def write(fh):
        fh.write("CHROM\tFIRST\tLAST\tCOPY_NUMBER\tQUALITY\n")
        for c in cnvs:
            fh.write(
                f"{c.sequence_name}\t{c.first}\t{c.last}\t{c.copy_number}\t{c.quality}\n"
            )

    _write_report(out, write)
    print(f"Called {len(cnvs)} CNVs", file=sys.stderr)


register(
    Command(
        id="ReadDepthComparator",
        former_id="CompareRD",
        group="Discovery",
        description="Case-control read-depth CNV detection (CNV-seq)",
        runner=_run_read_depth_comparator,
        options=[
            Option("r", "genome", "str", None, "Reference genome FASTA"),
            Option("o", "output_file", "str", None, "Output file"),
            Option("b", "bin_size", "int", 100, "Bin size"),
            Option("x", "min_ratio", "float", 2.0, "Minimum depth ratio"),
        ],
    )
)


def _run_alignment_statistics(calculator, usage: str, opts: dict,
                              args: list[str]) -> None:
    """Shared body of CoverageStats and BasePairQualStats: feed every
    alignment of the input to a call/coverage.py calculator, print its
    report."""
    from ..core.genome import ReferenceGenome
    from ..io.sam import ReadAlignmentFileReader

    genome_path = opts.pop("genome", None)
    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not genome_path or not inp:
        raise SystemExit(usage)
    calc = calculator(ReferenceGenome.load(genome_path))
    calc.process_alignments(list(ReadAlignmentFileReader(inp)))
    _write_report(opts.pop("output_file", None), calc.print_report)


def _run_coverage_stats(opts: dict, args: list[str], device) -> None:
    from ..call.coverage import CoverageStatisticsCalculator

    _run_alignment_statistics(
        CoverageStatisticsCalculator,
        "Usage: CoverageStats -r <genome.fa> -i <alns.sam> [-o out]", opts, args,
    )


def _run_bpqual_stats(opts: dict, args: list[str], device) -> None:
    from ..call.coverage import BasePairQualityStatisticsCalculator

    _run_alignment_statistics(
        BasePairQualityStatisticsCalculator,
        "Usage: BasePairQualStats -r <genome.fa> -i <alns.sam>", opts, args,
    )


_STATS_OPTIONS = [
    Option("r", "genome", "str", None, "Reference genome FASTA"),
    Option("i", "input_file", "str", None, "Input SAM"),
    Option("o", "output_file", "str", None, "Output file"),
]

register(
    Command(
        id="CoverageStats",
        group="Discovery",
        description="Coverage uniformity statistics from alignments",
        runner=_run_coverage_stats,
        options=_STATS_OPTIONS,
    )
)

register(
    Command(
        id="BasePairQualStats",
        former_id="QualStats",
        group="Discovery",
        description="Per-read-position mismatch rates vs the genome",
        runner=_run_bpqual_stats,
        options=_STATS_OPTIONS,
    )
)


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
                   "Run read-depth CNV detection"),
            Option("algCNV", "alg_cnv", "str", "CNVnator",
                   "Comma-separated CNV algorithms: CNVnator,EWT,PoissonHMM,MAXIMUMLIKELIHOOD"),
            Option("svs", "find_svs", "bool", False,
                   "Run read-pair SV detection"),
            Option("runLongReadSVs", "run_long_read_svs", "bool", False,
                   "Detect structural variants from long-read alignments"),
            Option("minSVQuality", "min_sv_quality", "int", 0,
                   "Min genotype quality for SV calls"),
            Option("knownSTRs", "known_strs_file", "str", None,
                   "Known STRs file"),
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


def _run_sih(opts: dict, args: list[str], device) -> None:
    from ..haplotyping.sih import SingleIndividualHaplotyper
    from ..io.sam import ReadAlignmentFileReader
    from ..vcf.io import VCFFileReader, VCFFileWriter

    vcf_in = opts.pop("input_file", None) or (args[0] if args else None)
    sam_in = opts.pop("alignments_file", None) or (args[1] if len(args) > 1 else None)
    out = opts.pop("output_file", None)
    if not vcf_in or not sam_in or not out:
        raise SystemExit("Usage: SIH -i <calls.vcf> -b <alns.sam> -o <phased.vcf>")
    reader = VCFFileReader(vcf_in)
    records = reader.load_all()
    alns = list(ReadAlignmentFileReader(sam_in))
    sih = SingleIndividualHaplotyper(**opts)  # host numpy: no device work
    blocks = sih.phase(records, alns)
    with VCFFileWriter(out, reader.sample_ids) as w:
        for r in records:
            w.write(r)
    print(
        f"Phased {sum(len(b.var_indices) for b in blocks)} variants in "
        f"{len(blocks)} blocks (MEC {sum(b.mec for b in blocks)})",
        file=sys.stderr,
    )


register(
    Command(
        id="SIH",
        group="Discovery",
        description="Single individual haplotyping (RefHap-style MEC search)",
        runner=_run_sih,
        options=[
            Option("i", "input_file", "str", None, "Single-sample VCF"),
            Option("b", "alignments_file", "str", None, "Alignments SAM"),
            Option("o", "output_file", "str", None, "Output phased VCF"),
            Option("a", "algorithm", "str", "Refhap", "Phasing algorithm: Refhap,Refhap2,Refhap3,DGS,Groups,HapChat,GenHap"),
        ],
    )
)


# ---- command ids not ported yet -----------------------------------------

_HMM = "ROADMAP.md Queue 1 item 14 (HMM consumers)"
_TAIL = "ROADMAP.md Queue 1 item 17 (the long tail)"

# id -> (group, description, former id, hidden, ROADMAP item)
_PENDING: dict[str, tuple[str, str, str | None, bool, str]] = {
    "TillingIndividualVCF2PoolVCF": ("Benchmark", "Convert an individuals VCF to the pooled-sample VCF a TILLING run would produce", None, False, _TAIL),
    "Demultiplex": ("Reads", "Demultiplexes pooled reads by barcodes", None, False, _TAIL),
    "IndividualGenomeBuilder": ("Reads", "Applies VCF variants to a genome FASTA", None, False, _TAIL),
    "GenomeAssemblyMask": ("Genomes", "Masks genome regions with N", None, False, _TAIL),
    "SingleReadsSimulator": ("Benchmark", "Simulates sequencing reads from a genome", None, False, _TAIL),
    "SingleIndividualSimulator": ("Benchmark", "Simulates a mutated individual genome with truth VCF", None, False, _TAIL),
    "VCFImpute": ("VariantsDownstream", "Imputes missing genotypes with a haplotype-cluster HMM", "ImputeVCF", False, _HMM),
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
}


for _cid, (_grp, _desc, _former, _hidden, _item) in _PENDING.items():
    register(
        Command(
            id=_cid, group=_grp, description=_desc, runner=None,
            former_id=_former, hidden=_hidden, pending=_item,
        )
    )
