"""Command implementations wired into the registry.

Command ids, groups, flags and former ids are those of
ngsepcore_tpu/cli/commands.py (the reference's CommandsDescriptor.xml).
31 commands are ported: KmersExtractor, GenomeIndexer, ReadsAligner
(short and long reads), ReadsFileErrorsCorrector, Assembler,
AssemblyGraphStatistics, SingleSampleVariantsDetector, SIH,
MultisampleVariantsDetector, ReadDepthComparator, CoverageStats,
BasePairQualStats; the genome builders and simulators
(IndividualGenomeBuilder, GenomeAssemblyMask, SingleReadsSimulator,
SingleIndividualSimulator); VCFImpute (which also takes -seed); and the VCF
downstream commands (VCFFilter, VCFSummaryStats, VCFDiversityStats,
VCFVariantDensityCalculator, VCFDistanceMatrixCalculator, NeighborJoining,
DistanceClusteringService, VCFComparator, VCFConverter, VCFMerge,
MergeVariants, RelativeAlleleCountsCalculator, VCFAlleleSharingStats,
VCFIntrogressionAnalysis).  Every other id is registered as pending:
running it exits with an error naming the ROADMAP.md item that ports it.
Runners take the device the CLI's --device flag names.
"""
from __future__ import annotations

import contextlib
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


# ---- genome builders and simulators (ROADMAP.md Queue 1 item 17a) -------

def _run_individual_genome_builder(opts: dict, args: list[str], device) -> None:
    from ..core.genome import ReferenceGenome
    from ..genome.builders import build_individual_genome
    from ..io.fasta import save_fasta
    from ..vcf.io import VCFFileReader

    if len(args) < 3:
        raise SystemExit(
            "Usage: IndividualGenomeBuilder <genome.fa> <variants.vcf> <out.fa>"
        )
    genome = ReferenceGenome.load(args[0])
    records = VCFFileReader(args[1]).load_all()
    seqs = build_individual_genome(genome, records, **opts)  # host numpy
    save_fasta(seqs, args[2])
    print(f"Applied variants to genome -> {args[2]}", file=sys.stderr)


register(
    Command(
        id="IndividualGenomeBuilder",
        group="Reads",
        description="Applies VCF variants to a genome FASTA",
        runner=_run_individual_genome_builder,
        options=[Option("p", "haplotype", "int", 0, "Haplotype index for het calls")],
    )
)


def _run_genome_mask(opts: dict, args: list[str], device) -> None:
    from ..core.genome import ReferenceGenome
    from ..genome.builders import load_regions_file, mask_genome_regions
    from ..io.fasta import save_fasta

    if len(args) < 3:
        raise SystemExit("Usage: GenomeAssemblyMask <genome.fa> <regions.txt> <out.fa>")
    genome = ReferenceGenome.load(args[0])
    regions = load_regions_file(args[1])
    seqs = mask_genome_regions(genome, regions)  # host numpy
    save_fasta(seqs, args[2])
    print(f"Masked {len(regions)} regions -> {args[2]}", file=sys.stderr)


register(
    Command(
        id="GenomeAssemblyMask",
        group="Genomes",
        description="Masks genome regions with N",
        runner=_run_genome_mask,
        options=[],
    )
)


def _run_reads_simulator(opts: dict, args: list[str], device) -> None:
    from ..core.genome import ReferenceGenome
    from ..io.fastq import write_fastq
    from ..simulation.reads_simulator import SingleReadsSimulator

    if len(args) < 2:
        raise SystemExit("Usage: SingleReadsSimulator <genome.fa> <out.fastq> [-n N]")
    n = int(opts.pop("num_reads", 10000) or 10000)
    genome = ReferenceGenome.load(args[0])
    sim = SingleReadsSimulator(genome, **opts)  # host numpy
    write_fastq(sim.simulate(n), args[1])
    print(f"Simulated {n} reads -> {args[1]}")


register(
    Command(
        id="SingleReadsSimulator",
        group="Benchmark",
        description="Simulates sequencing reads from a genome",
        runner=_run_reads_simulator,
        options=[
            Option("n", "num_reads", "int", 10000, "Number of reads"),
            Option("l", "read_length", "int", 100, "Read length"),
            Option("e", "substitution_error_rate", "float", 0.005, "Substitution rate"),
            Option("s", "seed", "int", 1, "Random seed"),
        ],
    )
)


def _run_individual_simulator(opts: dict, args: list[str], device) -> None:
    from ..core.genome import ReferenceGenome
    from ..io.fasta import save_fasta
    from ..simulation.individual_simulator import SingleIndividualSimulator

    if len(args) < 2:
        raise SystemExit(
            "Usage: SingleIndividualSimulator <genome.fa> <out_prefix> [-s rate]"
        )
    genome = ReferenceGenome.load(args[0])
    sim = SingleIndividualSimulator(genome, **opts)  # host numpy
    sim.simulate()
    sim.write_truth_vcf(args[1] + "_truth.vcf")
    haps = sim.build_haplotype_genomes()
    for h, hg in enumerate(haps):
        for s in hg.sequences:
            s.name = f"{s.name}_hap{h}"
        save_fasta(hg.sequences, f"{args[1]}_hap{h}.fa")
    print(f"Simulated {len(sim.calls)} variants -> {args[1]}_truth.vcf")


register(
    Command(
        id="SingleIndividualSimulator",
        group="Benchmark",
        description="Simulates a mutated individual genome with truth VCF",
        runner=_run_individual_simulator,
        options=[
            Option("s", "snv_rate", "float", 0.001, "SNV rate"),
            Option("i", "indel_rate", "float", 0.0001, "Indel rate"),
            Option("p", "ploidy", "int", 2, "Ploidy"),
            Option("seed", "seed", "int", 1, "Random seed"),
            Option("id", "sample_id", "str", "simulated", "Sample id"),
        ],
    )
)


# ---- imputation (ROADMAP.md Queue 1 item 14) ------------------------------

def _run_vcf_impute(opts: dict, args: list[str], device) -> None:
    from ..imputation.genotype_imputer import GenotypeImputer

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    out = opts.pop("output_prefix", None) or (args[1] if len(args) > 1 else None)
    if not inp or not out:
        raise SystemExit("Usage: VCFImpute -i <in.vcf> -o <prefix>")
    GenotypeImputer(**opts, device=device).run(inp, out)
    print(f"Imputed genotypes -> {out}_imputed.vcf")


register(
    Command(
        id="VCFImpute",
        former_id="ImputeVCF",
        group="VariantsDownstream",
        description="Imputes missing genotypes with a haplotype-cluster HMM",
        runner=_run_vcf_impute,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_prefix", "str", None, "Output prefix"),
            Option("k", "k", "int", 8, "Number of haplotype clusters"),
            Option("w", "window_size", "int", 5000, "Sites per window"),
            Option("v", "overlap", "int", 50, "Window overlap"),
            Option("c", "avg_cm_per_kbp", "float", 0.001, "Avg cM per kbp"),
            Option("t", "n_iterations", "int", 10, "Baum-Welch iterations"),
            Option("seed", "seed", "int", 1,
                   "Seed of the clusters' start frequencies (GenotypeImputer's seed)"),
        ],
    )
)


# ---- VCF downstream (ROADMAP.md Queue 1 item 17b) -------------------------

def _load_vcf(path: str):
    from ..vcf.io import VCFFileReader

    reader = VCFFileReader(path)
    records = reader.load_all()
    return reader, records


@contextlib.contextmanager
def _output(opts: dict):
    """The -o file (closed at the end), or standard output."""
    out = opts.pop("output_file", None)
    if out:
        with open(out, "w") as fh:
            yield fh
    else:
        yield sys.stdout


def _run_vcf_filter(opts: dict, args: list[str], device) -> None:
    from ..core.regions import GenomicRegionSortedCollection
    from ..genome.builders import load_regions_file
    from ..vcf.analytics import VCFFilter
    from ..vcf.io import VCFFileWriter

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    out = opts.pop("output_file", None) or (args[1] if len(args) > 1 else None)
    if not inp or not out:
        raise SystemExit("Usage: VCFFilter -i <in.vcf> -o <out.vcf> [filters]")
    for key in ("regions_to_filter", "regions_to_select"):
        path = opts.pop(key, None)
        if path:
            coll = GenomicRegionSortedCollection()
            for r in load_regions_file(path):
                coll.add(r)
            opts[key] = coll
    saf = opts.pop("sample_ids", None)
    if saf:
        with open(saf) as fh:
            opts["sample_ids"] = [
                ln.split()[0].split("\t")[0] for ln in fh if ln.strip()
            ]
    gpath = opts.pop("genome", None)
    if gpath:
        from ..core.genome import ReferenceGenome

        opts["genome"] = ReferenceGenome.load(gpath)
    ann = opts.pop("annotations", None)
    if ann:
        opts["annotations"] = set(ann.split(","))
    reader, records = _load_vcf(inp)
    kept = VCFFilter(**opts).apply(records)  # host
    with VCFFileWriter(out, reader.sample_ids) as w:
        for r in kept:
            w.write(r)
    print(f"Kept {len(kept)} of {len(records)} records", file=sys.stderr)


register(
    Command(
        id="VCFFilter",
        former_id="FilterVCF",
        group="VariantsDownstream",
        description="Filters VCF sites and genotypes",
        runner=_run_vcf_filter,
        options=[
            # full reference surface (CommandsDescriptor.xml VCFFilter)
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_file", "str", None, "Output VCF"),
            Option("frs", "regions_to_filter", "str", None,
                   "File with regions to filter out"),
            Option("srs", "regions_to_select", "str", None,
                   "File with regions to select"),
            Option("d", "min_distance", "int", 0,
                   "Minimum distance between variants"),
            Option("q", "min_genotype_quality", "int", 0,
                   "Minimum genotype quality (GQ)"),
            Option("minRD", "min_depth", "int", 0,
                   "Minimum genotype read depth (DP)"),
            Option("s", "keep_biallelic_snvs", "bool", False,
                   "Keep only biallelic SNVs"),
            Option("fi", "filter_invariant", "bool", False,
                   "Filter sites with one observed allele"),
            Option("fir", "filter_invariant_reference", "bool", False,
                   "Filter sites with only the reference allele"),
            Option("fia", "filter_invariant_alternative", "bool", False,
                   "Filter sites with only one alternative allele"),
            Option("m", "min_samples_genotyped", "int", 0,
                   "Min samples genotyped"),
            Option("minMAF", "min_maf", "float", 0.0, "Minimum MAF"),
            Option("maxMAF", "max_maf", "float", 0.5, "Maximum MAF"),
            Option("minOH", "min_oh", "float", 0.0, "Minimum observed het"),
            Option("maxOH", "max_oh", "float", 1.0, "Maximum observed het"),
            Option("g", "genome", "str", None,
                   "Reference genome FASTA for GC content"),
            Option("minGC", "min_gc_content", "float", 0.0,
                   "Minimum GC%% of the surrounding 100bp region"),
            Option("maxGC", "max_gc_content", "float", 100.0,
                   "Maximum GC%% of the surrounding 100bp region"),
            Option("maxCNVs", "max_samples_cnvs", "int", -1,
                   "Max samples with CNVs (INFO CNV)"),
            Option("gene", "gene_id", "str", None,
                   "Gene/transcript id (TID/TGN INFO)"),
            Option("a", "annotations", "str", None,
                   "Comma-separated functional annotations (TA INFO)"),
            Option("saf", "sample_ids", "str", None,
                   "File with sample ids to select/remove"),
            Option("fs", "filter_samples", "bool", False,
                   "Remove (not select) the -saf samples"),
        ],
    )
)


def _run_vcf_summary(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import VCFSummaryStatisticsCalculator

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: VCFSummaryStats <in.vcf> [-o out.txt]")
    _, records = _load_vcf(inp)
    calc = VCFSummaryStatisticsCalculator()
    for r in records:
        calc.process(r)
    with _output(opts) as fh:
        calc.print_report(fh)


register(
    Command(
        id="VCFSummaryStats",
        former_id="SummaryStats",
        group="VariantsDownstream",
        description="Variant count reports by category",
        runner=_run_vcf_summary,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


def _run_vcf_diversity(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import site_diversity

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: VCFDiversityStats <in.vcf> [-o out.txt]")
    _, records = _load_vcf(inp)
    with _output(opts) as fh:
        fh.write("CHROM\tPOS\tGENOTYPED\tMAF\tOH\tEH\tF\n")
        for r in records:
            d = site_diversity(r)
            v = r.variant
            fh.write(
                f"{v.sequence_name}\t{v.first}\t{d.genotyped}\t{d.maf:.4f}\t"
                f"{d.observed_het:.4f}\t{d.expected_het:.4f}\t{d.f:.4f}\n"
            )


register(
    Command(
        id="VCFDiversityStats",
        former_id="DiversityStats",
        group="VariantsDownstream",
        description="Per-site diversity statistics (MAF, heterozygosity, F)",
        runner=_run_vcf_diversity,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


def _run_vcf_density(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import variant_density

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: VCFVariantDensityCalculator <in.vcf> [-w window]")
    _, records = _load_vcf(inp)
    window = int(opts.pop("window", 100000) or 100000)
    with _output(opts) as fh:
        for seq, start, count in variant_density(records, window):
            fh.write(f"{seq}\t{start}\t{start + window - 1}\t{count}\n")


register(
    Command(
        id="VCFVariantDensityCalculator",
        group="VariantsDownstream",
        description="Variant density in genome windows",
        runner=_run_vcf_density,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_file", "str", None, "Output file"),
            Option("w", "window", "int", 100000, "Window length"),
        ],
    )
)


def _run_vcf_distance_matrix(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import distance_matrix, write_distance_matrix

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: VCFDistanceMatrixCalculator <in.vcf> [-o out.txt]")
    _, records = _load_vcf(inp)
    dist, samples = distance_matrix(records, device=device)
    with _output(opts) as fh:
        write_distance_matrix(dist, samples, fh)


register(
    Command(
        id="VCFDistanceMatrixCalculator",
        group="VariantsDownstream",
        description="Genetic distance matrix from genotype calls",
        runner=_run_vcf_distance_matrix,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


def _run_tree(opts: dict, args: list[str], algorithm: str) -> None:
    from ..clustering.trees import neighbor_joining, upgma
    from ..vcf.analytics import load_distance_matrix

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: NeighborJoining <matrix.txt> [-o out.nwk]")
    with open(inp) as fh:
        dist, names = load_distance_matrix(fh)
    # host numpy
    tree = neighbor_joining(dist, names) if algorithm == "NJ" else upgma(dist, names)
    with _output(opts) as fh:
        fh.write(tree.to_newick() + "\n")


register(
    Command(
        id="NeighborJoining",
        group="VariantsDownstream",
        description="Neighbor-joining dendrogram from a distance matrix",
        runner=lambda o, a, device: _run_tree(o, a, "NJ"),
        options=[
            Option("i", "input_file", "str", None, "Distance matrix file"),
            Option("o", "output_file", "str", None, "Output Newick file"),
        ],
    )
)

register(
    Command(
        id="DistanceClusteringService",
        group="VariantsDownstream",
        description="Tree building from a distance matrix (NJ or UPGMA)",
        runner=lambda o, a, device: _run_tree(o, a, o.pop("algorithm", "NJ") or "NJ"),
        hidden=True,
        options=[
            Option("i", "input_file", "str", None, "Distance matrix file"),
            Option("o", "output_file", "str", None, "Output Newick file"),
            Option("t", "algorithm", "str", "NJ", "NJ or UPGMA"),
        ],
    )
)


def _run_vcf_comparator(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import compare_vcfs

    if len(args) < 2:
        raise SystemExit("Usage: VCFComparator <a.vcf> <b.vcf>")
    _, r1 = _load_vcf(args[0])
    _, r2 = _load_vcf(args[1])
    res = compare_vcfs(r1, r2)  # host
    print(
        f"Both genotyped: {res.both_genotyped}\nConcordant: {res.concordant}\n"
        f"Concordance: {res.concordance:.4f}\nOnly first: {res.only_first}\n"
        f"Only second: {res.only_second}"
    )


register(
    Command(
        id="VCFComparator",
        former_id="CompareVCF",
        group="VariantsDownstream",
        description="Genotype concordance between two VCFs",
        runner=_run_vcf_comparator,
        options=[],
    )
)


def _run_vcf_converter(opts: dict, args: list[str], device) -> None:
    from ..vcf.converter import (
        CONVERTERS,
        POPULATION_CONVERTERS,
        convert_finestructure,
        convert_joinmap,
    )

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    out = opts.pop("output_prefix", None) or (args[1] if len(args) > 1 else "converted")
    if not inp:
        raise SystemExit("Usage: VCFConverter -i <in.vcf> -o <prefix> -f <formats,csv>")
    formats = (opts.pop("formats", None) or "Matrix").split(",")
    pops_file = opts.pop("populations_file", None)
    populations = {}
    if pops_file:
        with open(pops_file) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    populations[parts[0]] = parts[1]
    parent1 = opts.pop("parent1", None)
    parent2 = opts.pop("parent2", None)
    seq_name = opts.pop("sequence_name", None)
    _, records = _load_vcf(inp)
    for f in formats:  # host text
        if f == "JoinMap":
            convert_joinmap(records, out, parent1=parent1, parent2=parent2)
        elif f == "FineStructure":
            convert_finestructure(records, out, sequence_name=seq_name)
        elif f in CONVERTERS:
            CONVERTERS[f](records, out)
        elif f in POPULATION_CONVERTERS:
            POPULATION_CONVERTERS[f](records, populations, out)
        else:
            raise SystemExit(
                f"Unknown format {f}. Available: "
                + ",".join(list(CONVERTERS) + list(POPULATION_CONVERTERS))
            )
    print(f"Converted {len(records)} records to {formats}", file=sys.stderr)


register(
    Command(
        id="VCFConverter",
        former_id="ConvertVCF",
        group="VariantsDownstream",
        description="Exports genotypes to population-genetics formats",
        runner=_run_vcf_converter,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("o", "output_prefix", "str", None, "Output prefix"),
            Option("f", "formats", "str", "Matrix", "Comma-separated formats"),
            Option("p", "populations_file", "str", None, "Sample->population map"),
            Option("p1", "parent1", "str", None, "Parent 1 sample id (JoinMap)"),
            Option("p2", "parent2", "str", None, "Parent 2 sample id (JoinMap)"),
            Option("seq", "sequence_name", "str", None,
                   "Sequence name (FineStructure)"),
        ],
    )
)


def _run_vcf_merge(opts: dict, args: list[str], device) -> None:
    from ..vcf.analytics import merge_vcfs
    from ..vcf.io import VCFFileWriter

    out = opts.pop("output_file", None)
    if not out or len(args) < 2:
        raise SystemExit("Usage: VCFMerge -o <out.vcf> <in1.vcf> <in2.vcf> ...")
    lists = []
    samples = []
    for path in args:
        reader, records = _load_vcf(path)
        lists.append(records)
        samples.append(reader.sample_ids[0] if reader.sample_ids else path)
    merged = merge_vcfs(lists, samples)  # host
    with VCFFileWriter(out, samples) as w:
        for r in merged:
            w.write(r)
    print(f"Merged {len(merged)} sites from {len(args)} files", file=sys.stderr)


register(
    Command(
        id="VCFMerge",
        former_id="MergeVCF",
        group="Discovery",
        description="Merges per-sample VCFs into a population VCF",
        runner=_run_vcf_merge,
        options=[Option("o", "output_file", "str", None, "Output VCF")],
    )
)


def _run_merge_variants(opts: dict, args: list[str], device) -> None:
    from ..vcf.io import VCFFileWriter, VCFRecord

    out = opts.pop("output_file", None)
    if not out or len(args) < 1:
        raise SystemExit("Usage: MergeVariants -o <out.vcf> <v1.vcf> <v2.vcf> ...")
    sites = {}
    for path in args:
        _, records = _load_vcf(path)
        for r in records:
            key = (r.variant.sequence_name, r.variant.first, tuple(r.variant.alleles))
            if key not in sites:
                sites[key] = r.variant
    with VCFFileWriter(out, []) as w:
        for key in sorted(sites, key=lambda k: (k[0], k[1])):
            w.write(VCFRecord(variant=sites[key], calls=[]))
    print(f"Merged {len(sites)} variant sites", file=sys.stderr)


register(
    Command(
        id="MergeVariants",
        group="Discovery",
        description="Merges variant site lists across samples (no genotypes)",
        runner=_run_merge_variants,
        options=[Option("o", "output_file", "str", None, "Output VCF")],
    )
)


def _run_relative_allele_counts(opts: dict, args: list[str], device) -> None:
    import numpy as np

    from ..call.pileup import expand_batch_calls
    from ..io.sam import ReadAlignmentFileReader
    from ..vcf.popgen import relative_allele_counts

    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp:
        raise SystemExit("Usage: RelativeAlleleCountsCalculator <alns.sam>")
    alns = list(ReadAlignmentFileReader(inp))
    pos, allele, qual, strand, _ = expand_batch_calls(alns, collect_indels=False)
    order = np.argsort(pos, kind="stable")
    pos, allele = pos[order], allele[order]
    depths = []
    starts = np.nonzero(np.concatenate([[True], pos[1:] != pos[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(pos)]])
    for s, e in zip(starts, ends):
        counts = np.bincount(np.clip(allele[s:e], 0, 4), minlength=5)[:4]
        top = np.sort(counts)[::-1]
        if top[1] > 0:
            depths.append((int(top[0]), int(top[1])))
    hist = relative_allele_counts(depths)
    with _output(opts) as fh:
        fh.write("MinorFraction\tSites\n")
        for i, c in enumerate(hist):
            fh.write(f"{i / (len(hist) - 1):.3f}\t{int(c)}\n")


register(
    Command(
        id="RelativeAlleleCountsCalculator",
        former_id="RelativeAlleleCounts",
        group="Discovery",
        description="Relative allele-count distribution (ploidy/contamination QC)",
        runner=_run_relative_allele_counts,
        options=[
            Option("i", "input_file", "str", None, "Input SAM"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


def _load_groups_file(path: str) -> dict:
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def _run_allele_sharing(opts: dict, args: list[str], device) -> None:
    from ..vcf.popgen import allele_sharing_stats

    groups_file = opts.pop("groups_file", None)
    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp or not groups_file:
        raise SystemExit("Usage: VCFAlleleSharingStats -i <in.vcf> -g <groups.txt>")
    _, records = _load_vcf(inp)
    stats = allele_sharing_stats(records, _load_groups_file(groups_file),
                                 window=int(opts.pop("window", 100000) or 100000))
    with _output(opts) as fh:
        fh.write("SEQ\tFIRST\tSITES\tWITHIN_A\tWITHIN_B\tBETWEEN\n")
        for s in stats:
            fh.write(
                f"{s['sequence']}\t{s['first']}\t{s['sites']}\t{s['within_a']:.4f}"
                f"\t{s['within_b']:.4f}\t{s['between']:.4f}\n"
            )


register(
    Command(
        id="VCFAlleleSharingStats",
        former_id="AlleleSharingStats",
        group="VariantsDownstream",
        description="Window allele-sharing diversity between sample groups",
        runner=_run_allele_sharing,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("g", "groups_file", "str", None, "Sample->group file"),
            Option("w", "window", "int", 100000, "Window size"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


def _run_introgression(opts: dict, args: list[str], device) -> None:
    from ..vcf.popgen import introgression_analysis

    groups_file = opts.pop("groups_file", None)
    inp = opts.pop("input_file", None) or (args[0] if args else None)
    if not inp or not groups_file:
        raise SystemExit("Usage: VCFIntrogressionAnalysis -i <in.vcf> -g <groups.txt>")
    _, records = _load_vcf(inp)
    hits = introgression_analysis(
        records, _load_groups_file(groups_file),
        window=int(opts.pop("window", 100000) or 100000),
    )
    with _output(opts) as fh:
        fh.write("SAMPLE\tSEQ\tFIRST\tSCORE\tSITES\n")
        for h in hits:
            fh.write(f"{h['sample']}\t{h['sequence']}\t{h['first']}\t{h['score']:.3f}\t{h['sites']}\n")


register(
    Command(
        id="VCFIntrogressionAnalysis",
        former_id="IntrogressionAnalysis",
        group="VariantsDownstream",
        description="Window-based haplotype introgression detection",
        runner=_run_introgression,
        options=[
            Option("i", "input_file", "str", None, "Input VCF"),
            Option("g", "groups_file", "str", None, "Sample->population file"),
            Option("w", "window", "int", 100000, "Window size"),
            Option("o", "output_file", "str", None, "Output file"),
        ],
    )
)


# ---- command ids not ported yet -----------------------------------------

_TAIL = "ROADMAP.md Queue 1 item 17 (the long tail)"

# id -> (group, description, former id, hidden, ROADMAP item)
_PENDING: dict[str, tuple[str, str, str | None, bool, str]] = {
    "TillingIndividualVCF2PoolVCF": ("Benchmark", "Convert an individuals VCF to the pooled-sample VCF a TILLING run would produce", None, False, _TAIL),
    "Demultiplex": ("Reads", "Demultiplexes pooled reads by barcodes", None, False, _TAIL),
    "VCFGoldStandardComparator": ("Benchmark", "Genotype-aware TP/FP/FN vs a gold standard per quality bin", None, False, _TAIL),
    "VCFAnnotate": ("VariantsDownstream", "Functional annotation of variants vs gene models (SO terms)", "Annotate", False, _TAIL),
    "GenomesAligner": ("Genomes", "Whole-genome ortholog and synteny comparison", None, False, _TAIL),
    "CDNACatalogAligner": ("Genomes", "Orthogroups from cDNA/protein catalogs", None, False, _TAIL),
    "TranscriptomeAnalyzer": ("Genomes", "Gene-model statistics from a GFF3", None, False, _TAIL),
    "DeNovoGBS": ("Reads", "De-novo GBS read clustering and variant calling", None, False, _TAIL),
    "TransposonsFinder": ("Genomes", "Transposable element / repeat annotation", None, False, _TAIL),
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
