"""Smoke run of ngsepcore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ngsepcore_tpu_torch/csrc (first use), holds
each against its plain PyTorch version on the card (phases 2-3), checks
the fused align+call pipeline on CUDA against the same pipeline on the CPU
(phase 4), runs it at a bacterial-isolate WGS size (4.6 Mbp diploid
genome with repeat families and tandem arrays, 345,000 x 150 bp reads,
11.25x) with bench.py's accuracy gates (phase 5), checks the classic
two-stage flow (phase 6) and the span-scatter genotyper (phase 7) on CUDA
against the CPU at 50 kb, and runs the CLI (ReadsAligner -> SAM ->
SingleSampleVariantsDetector -> VCF, as subprocesses) on phase 5's data
with the same gates (phase 8).  Prints one line per phase and exits
nonzero at the first failure.  The last lines are a JSON object of the
kernels (launch counts from the timed runs of phases 5 and 6, errors and
times measured here), the card's name and power limit, and the result
line.

Imports torch, numpy and the port only (bench.py's gates are numpy).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = nvidia_smi()
    print(smi, flush=True)
    # the genotyper's float32 screen must run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"phase 0 device: {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build():
    from ngsepcore_tpu_torch.kernels import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f}s -> "
        f"{cuda_build.build_info['path']}")
    for line in cuda_build.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)


# ---------------------------------------------------------------------------
def _bench_chunk(rng, B, Lq, Ls):
    """Read-like tier-3 jobs (the generator of bench.measure_dp_cell_rate):
    the query embedded at column 40 with 2% substitutions."""
    q = rng.integers(0, 4, (B, Lq), dtype=np.int8)
    s = rng.integers(0, 4, (B, Ls), dtype=np.int8)
    w = min(Lq, Ls - 40)
    s[:, 40 : 40 + w] = np.where(
        rng.random((B, w)) < 0.02, rng.integers(0, 4, (B, w), dtype=np.int8), q[:, :w]
    )
    ql = np.full(B, min(150, Lq), np.int32)
    sl = np.full(B, min(250, Ls), np.int32)
    return q, ql, s, sl


def _noisy(rng, B, Lq, Ls):
    """tests/test_pairwise_pallas.py's generator: queries with a few indels
    embedded in random subjects, ragged qlen/slen."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    s = rng.integers(0, 4, (B, Ls)).astype(np.int8)
    for b in range(B):
        off = int(rng.integers(0, max(1, Ls - Lq - 5)))
        piece = list(q[b][: Lq - 6])
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(1, len(piece) - 1))
            if rng.random() < 0.5:
                piece.insert(p, int(rng.integers(0, 4)))
            else:
                del piece[p]
        piece = np.array(piece[: Ls - off], np.int8)
        s[b, off : off + len(piece)] = piece
    ql = rng.integers(Lq // 2, Lq + 1, B).astype(np.int32)
    sl = rng.integers(int(Ls * 0.8), Ls + 1, B).astype(np.int32)
    return q, ql, s, sl


def _classic_chunk(rng, B, read_len=150, Lq=192, Ls=192):
    """Classic tier-3 jobs (ReadsAligner._tier3_dispatch): the read's
    subject window starts 3 bases before its predicted start and is
    read_len + 6 wide, query and subject padded with N to 64-granular
    widths; 2% substitutions."""
    q = np.full((B, Lq), 4, np.int8)
    s = np.full((B, Ls), 4, np.int8)
    win = rng.integers(0, 4, (B, read_len + 6), dtype=np.int8)
    s[:, : read_len + 6] = win
    q[:, :read_len] = np.where(
        rng.random((B, read_len)) < 0.02,
        rng.integers(0, 4, (B, read_len), dtype=np.int8),
        win[:, 3 : 3 + read_len],
    )
    return (q, np.full(B, read_len, np.int32), s,
            np.full(B, read_len + 6, np.int32))


def phase_gotoh():
    import torch

    from ngsepcore_tpu_torch.kernels.pairwise_cuda import (
        gotoh_forward_plane,
        gotoh_forward_plane_ref,
    )

    rng = np.random.default_rng(0)
    cases = [
        ("bench chunk 2048x160x256", _bench_chunk(rng, 2048, 160, 256), {}),
        ("main-path chunk 2048x160x160", _bench_chunk(rng, 2048, 160, 160), {}),
        ("ragged 1000x160x200", _noisy(rng, 1000, 160, 200), {}),
        ("classic tier-3 2048x192x192", _classic_chunk(rng, 2048), {}),
        ("classic tier-3 256x192x192", _classic_chunk(rng, 256), {}),
    ]
    for cfg in (
        dict(free_start2=True, free_end2=True),
        dict(free_start2=False, free_end2=False),
        dict(free_start2=True, free_end2=False),
    ):
        cases.append((f"pallas-test 256x48x128 {cfg}", _noisy(rng, 256, 48, 128), cfg))
    timing = {}
    for name, (q, ql, s, sl), cfg in cases:
        args = [torch.from_numpy(a).cuda() for a in (q, ql, s, sl)]
        kern = gotoh_forward_plane(*args, **cfg)
        ref = gotoh_forward_plane_ref(*args, **cfg)
        torch.cuda.synchronize()
        Lq, Ls = q.shape[1], s.shape[1]
        rows = torch.arange(1, Lq + 1, device="cuda")[:, None, None]
        cols = torch.arange(1, Ls + 1, device="cuda")[None, None, :]
        mask = (rows <= args[1][None, :, None]) & (cols <= args[3][None, :, None])
        bad = int(((kern[0] != ref[0]) & mask).sum())
        full = int((kern[0] != ref[0]).sum())
        vec_bad = [int((a != b).sum()) for a, b in zip(kern[1:], ref[1:])]
        err = max(
            [int(((kern[0].long() - ref[0].long()).abs() * mask).max())]
            + [int((a.long() - b.long()).abs().max()) for a, b in zip(kern[1:], ref[1:])]
        )
        log(f"phase 2 gotoh {name}: masked plane mismatches {bad}, "
            f"full-plane mismatches {full}, score/end_i/end_j/start_k "
            f"mismatches {vec_bad}")
        if bad or any(vec_bad):
            fail(f"gotoh kernel disagrees with its plain version on {name}")
        if name.startswith(("bench", "main-path", "classic")):
            ms = cuda_ms(lambda: gotoh_forward_plane(*args, **cfg))
            plain = cuda_ms(lambda: gotoh_forward_plane_ref(*args, **cfg))
            log(f"  time {name}: kernel {ms:.3f} ms, plain {plain:.3f} ms "
                "(median of 5)")
            timing[name] = (ms, plain, err)
        del kern, ref
    return timing


def phase_shear():
    import torch

    from ngsepcore_tpu_torch.kernels.shear_pileup import shear_hist, shear_hist_ref

    rng = np.random.default_rng(1)
    lanes, window = 160, 1 << 20
    S = lanes + window + 256
    timing = {}
    for nq in (1, 6):
        ncnt = 4 * nq + 2
        col = rng.integers(0, ncnt, (lanes, S))
        strand = rng.integers(0, 2, (lanes, S))
        st = (col | (strand << 7)).astype(np.uint8)
        st[rng.random((lanes, S)) < 0.4] = 0xFF
        stage = torch.from_numpy(st).cuda()
        w0s = lanes - 1  # window starts at the halo
        kern = shear_hist(stage, w0s, window=window, nq=nq, lanes=lanes)
        ref = shear_hist_ref(stage, w0s, window=window, nq=nq, lanes=lanes)
        torch.cuda.synchronize()
        bad = int((kern != ref).sum())
        err = int((kern - ref).abs().max())
        log(f"phase 3 shear nq={nq} window={window} lanes={lanes}: "
            f"mismatches {bad}")
        if bad:
            fail(f"shear kernel disagrees with its plain version (nq={nq})")
        ms = cuda_ms(lambda: shear_hist(stage, w0s, window=window, nq=nq, lanes=lanes))
        plain = cuda_ms(
            lambda: shear_hist_ref(stage, w0s, window=window, nq=nq, lanes=lanes)
        )
        log(f"  time nq={nq}: kernel {ms:.3f} ms, plain {plain:.3f} ms (median of 5)")
        timing[nq] = (ms, plain, err)
        del stage, kern, ref
    return timing


# ---------------------------------------------------------------------------
def record_key(rec):
    """tests/test_fused_pipeline.py's record identity."""
    v = rec.variant
    c = rec.calls[0]
    return (
        v.sequence_name, v.first, tuple(v.alleles),
        tuple(c.indexes_called_alleles), int(c.genotype_quality),
        int(round(v.quality)), int(c.total_read_depth),
        tuple(c.acgt_depths or []), tuple(c.genotype_likelihoods or []),
    )


def _simulate_50kb(seed: int = 3):
    """tests/test_fused_pipeline.py::_simulate(with_indels=True)."""
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import QualifiedSequence, QualifiedSequenceList
    from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator

    rng = np.random.default_rng(seed)
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chrA", codes=rng.integers(0, 4, size=30000).astype(np.int8)))
    seqs.add(QualifiedSequence(name="chrB", codes=rng.integers(0, 4, size=20000).astype(np.int8)))
    genome = ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome, snv_rate=0.002, indel_rate=0.0005, seed=seed + 1)
    sim.simulate()
    reads = []
    for h, hg in enumerate(sim.build_haplotype_genomes()):
        reads.extend(
            SingleReadsSimulator(
                hg, read_length=100, substitution_error_rate=0.004, seed=seed + 10 + h
            ).simulate(2500)
        )
    for i in range(0, len(reads), 97):
        s = list(reads[i].sequence)
        s[len(s) // 2] = "N"
        reads[i] = type(reads[i])(name=reads[i].name, sequence="".join(s),
                                  qualities=reads[i].qualities)
    return genome, reads


def _make_pipeline(genome, device, batch_size, table=None):
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.fused_pipeline import AlignCallPipeline
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    return AlignCallPipeline(
        genome, aligner=ReadsAligner(genome, table=table, device=device),
        detector=SingleSampleVariantsDetector(genome, sample_id="s1", device=device),
        batch_size=batch_size, device=device,
    )


def _run_pipeline(genome, reads, device, batch_size, table=None):
    pipe = _make_pipeline(genome, device, batch_size, table)
    return pipe, pipe.run_reads(reads)


def phase_cuda_vs_cpu(counters):
    import torch

    genome, reads = _simulate_50kb()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    _, rec_cuda = _run_pipeline(genome, reads, "cuda", 1024)
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    t0 = time.perf_counter()
    _, rec_cpu = _run_pipeline(genome, reads, "cpu", 1024)
    t_cpu = time.perf_counter() - t0
    kc = [record_key(r) for r in rec_cuda]
    kp = [record_key(r) for r in rec_cpu]
    log(f"phase 4 50 kb indel workload: {len(kc)} records on CUDA "
        f"({t_cuda:.2f}s), {len(kp)} on CPU ({t_cpu:.2f}s), launches {launches}")
    if len(kc) <= 10 or kc != kp:
        fail("CUDA and CPU records differ on the 50 kb workload")
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the CUDA run: {launches}")
    return kc


# ---------------------------------------------------------------------------
GENOME_MBP = 4.6
N_READS = 345_000
READ_LEN = 150


def build_repeat_genome(rng, L: int, n_families: int, n_tandem: int):
    """bench.build_repeat_genome with its family and tandem-array counts as
    parameters: dispersed families at 92-99% identity plus short tandem
    arrays.  Returns (codes, merged repeat intervals)."""
    codes = rng.integers(0, 4, size=L).astype(np.int8)
    intervals = []
    for _fam in range(n_families):
        slen = int(rng.integers(500, 4000))
        src = int(rng.integers(0, L - slen))
        seg = codes[src : src + slen].copy()
        intervals.append((src, src + slen))
        for _copy in range(int(rng.integers(4, 16))):
            dst = int(rng.integers(0, L - slen))
            cp = seg.copy()
            div = float(rng.uniform(0.01, 0.08))
            nmut = int(rng.binomial(slen, div))
            if nmut:
                mpos = rng.choice(slen, size=nmut, replace=False)
                cp[mpos] = (cp[mpos] + rng.integers(1, 4, size=nmut)) % 4
            codes[dst : dst + slen] = cp
            intervals.append((dst, dst + slen))
    for _t in range(n_tandem):
        mlen = int(rng.integers(2, 7))
        ncopies = int(rng.integers(8, 41))
        span = mlen * ncopies
        dst = int(rng.integers(0, L - span))
        codes[dst : dst + span] = np.tile(
            rng.integers(0, 4, size=mlen).astype(np.int8), ncopies
        )
        intervals.append((dst, dst + span))
    intervals.sort()
    merged = [list(intervals[0])]
    for lo, hi in intervals[1:]:
        if lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return codes, np.asarray(merged, dtype=np.int64)


def phase_real_size(counters, device="cuda", mbp=GENOME_MBP, n_reads=N_READS):
    from bench import check_accuracy
    from ngsepcore_tpu_torch.core.genome import ReferenceGenome
    from ngsepcore_tpu_torch.core.sequences import (
        QualifiedSequence,
        QualifiedSequenceList,
        ReadBlock,
    )
    from ngsepcore_tpu_torch.index.minimizer_table import MinimizerTable
    from ngsepcore_tpu_torch.simulation.individual_simulator import SingleIndividualSimulator
    from ngsepcore_tpu_torch.simulation.reads_simulator import SingleReadsSimulator
    from ngsepcore_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    rng = np.random.default_rng(2024)
    L = int(mbp * 1e6)
    scale = mbp / 12.0  # bench.py's 12 Mbp genome: 30 families, 400 arrays
    codes, repeat_iv = build_repeat_genome(
        rng, L, round(30 * scale), round(400 * scale)
    )
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome0 = ReferenceGenome(seqs)
    sim = SingleIndividualSimulator(genome0, snv_rate=0.001, indel_rate=0.0001, seed=7)
    sim.simulate()
    hap = sim.build_haplotype_genomes()
    reads = ReadBlock.concatenate([
        SingleReadsSimulator(
            hg, read_length=READ_LEN, substitution_error_rate=0.003, seed=11 + h
        ).simulate_block(n_reads // 2)
        for h, hg in enumerate(hap)
    ])
    snvs = [c for c in sim.calls if c.is_snv]
    truth_snv = {(c.first, c.alleles[1]) for c in snvs}
    truth_indel_pos = np.array(sorted(c.first for c in sim.calls if not c.is_snv), np.int64)
    in_repeat = np.zeros(L + 2, bool)
    for lo, hi in repeat_iv:
        in_repeat[max(0, lo - READ_LEN) : hi + READ_LEN] = True
    seqs = QualifiedSequenceList()
    seqs.add(QualifiedSequence(name="chr1", codes=codes))
    genome = ReferenceGenome(seqs)
    bases = int(reads.lengths.astype(np.int64).sum())
    repeat_frac = float((repeat_iv[:, 1] - repeat_iv[:, 0]).sum()) / L
    log(f"phase 5 inputs: {L} bp, repeat fraction {repeat_frac:.4f}, "
        f"{len(reads)} reads, {bases / L:.2f}x, {len(snvs)} SNVs, "
        f"{len(truth_indel_pos)} indels ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    table = MinimizerTable.build_from_genome(genome, device=device)
    table.device_arrays(device)
    sync(device)
    log(f"  index on {device}: {len(table.unique_codes)} codes, "
        f"{table.size} entries, {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")

    profiling.enable()
    profiling.reset()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    pipe, records = _run_pipeline(genome, reads, device, 65536, table=table)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    profiling.enable(False)
    al = pipe.aligner
    log(f"  timed run: {dt:.3f}s = {len(reads) / dt:.1f} reads/s; "
        f"{len(records)} records; aligned {al.aligned_reads}, "
        f"tier-3 jobs {al.complete_alns}; launches {launches}")
    for name, (total, calls) in sorted(
        profiling._stages.items(), key=lambda kv: -kv[1][0]
    ):
        print(f"  stage {name:<28} {total:9.3f}s x{calls}", flush=True)
    acc = check_accuracy(records, truth_snv, truth_indel_pos, in_repeat)
    log(f"  accuracy: {json.dumps(acc['metrics'])}")
    if acc["gates"]:
        fail("accuracy gates: " + "; ".join(acc["gates"]))
    if device == "cuda" and min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    truth = (truth_snv, truth_indel_pos, in_repeat)
    return launches, dt, records, genome, reads, truth


# ---------------------------------------------------------------------------
def _run_classic(genome, reads, device):
    """ReadsAligner.align_batch in 1024-read batches, then
    SingleSampleVariantsDetector.find_variants: (SAM lines, records)."""
    from ngsepcore_tpu_torch.align.reads_aligner import ReadsAligner
    from ngsepcore_tpu_torch.call.single_sample import SingleSampleVariantsDetector

    aligner = ReadsAligner(genome, device=device)
    alns = []
    for i in range(0, len(reads), 1024):
        for per_read in aligner.align_batch(reads[i : i + 1024]):
            alns.extend(per_read)
    sam = ["\t".join(a.to_sam_fields()) for a in alns]
    det = SingleSampleVariantsDetector(genome, sample_id="s1", device=device)
    return sam, det.find_variants(alns), aligner


def phase_classic(counters, fused_keys):
    genome, reads = _simulate_50kb()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    sam_cuda, rec_cuda, al = _run_classic(genome, reads, "cuda")
    sync("cuda")
    t_cuda = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    t0 = time.perf_counter()
    sam_cpu, rec_cpu, _ = _run_classic(genome, reads, "cpu")
    t_cpu = time.perf_counter() - t0
    kc = [record_key(r) for r in rec_cuda]
    kp = [record_key(r) for r in rec_cpu]
    n_sam_diff = sum(a != b for a, b in zip(sam_cuda, sam_cpu))
    log(f"phase 6 classic 50 kb: {len(sam_cuda)} SAM lines, {len(kc)} records "
        f"on CUDA ({t_cuda:.2f}s), {len(kp)} on CPU ({t_cpu:.2f}s); "
        f"SAM lines differing {n_sam_diff}; tier-3 jobs {al.complete_alns}; "
        f"launches {launches}")
    if len(sam_cuda) != len(sam_cpu) or n_sam_diff:
        fail("classic CUDA and CPU SAM lines differ")
    if len(kc) <= 10 or kc != kp:
        fail("classic CUDA and CPU records differ")
    if kc != fused_keys:
        fail("classic records differ from the fused records of phase 4")
    if launches["gotoh_forward_plane"] == 0:
        fail(f"the classic tier-3 did not launch the Gotoh kernel: {launches}")
    return launches


def phase_span(counters):
    """The 50 kb reads with qualities redrawn over all 42 Phred values:
    31 levels after the 0..30 clamp, so the fused pipeline genotypes
    through the span-scatter path."""
    from ngsepcore_tpu_torch.core.sequences import RawRead

    genome, reads = _simulate_50kb()
    rng = np.random.default_rng(41)
    reads = [
        RawRead(
            name=r.name, sequence=r.sequence,
            qualities=(rng.integers(0, 42, len(r.sequence)) + 33)
            .astype(np.uint8).tobytes().decode("ascii"),
        )
        for r in reads
    ]
    keys = {}
    for device in ("cuda", "cpu"):
        pipe = _make_pipeline(genome, device, 1024)
        took = []
        span = pipe._genotype_span
        pipe._genotype_span = lambda *a, _s=span: took.append(1) or _s(*a)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        recs = pipe.run_reads(reads)
        sync(device)
        dt = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if took != [1]:
            fail(f"the {device} run did not take the span genotyper")
        keys[device] = [record_key(r) for r in recs]
        log(f"phase 7 span genotyper 50 kb, 31 quality levels, {device}: "
            f"{len(recs)} records ({dt:.2f}s), launches {launches}")
    if len(keys["cuda"]) <= 10 or keys["cuda"] != keys["cpu"]:
        fail("span-path CUDA and CPU records differ")


def _write_inputs(d, genome, reads):
    """FASTA of the genome and FASTQ of the reads (the block's default
    quality where it carries none)."""
    from ngsepcore_tpu_torch.io.fasta import save_fasta
    from ngsepcore_tpu_torch.io.fastq import write_fastq

    save_fasta(genome.sequences, os.path.join(d, "genome.fa"))
    write_fastq(reads, os.path.join(d, "reads.fastq"))


def _cli(args, timeout):
    """Run the port's CLI on the card in a subprocess with --profile;
    returns (seconds, stage-profile lines)."""
    cmd = [sys.executable, "-m", "ngsepcore_tpu_torch", "--device", "cuda",
           "--profile"] + args
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stderr[-4000:], flush=True)
        fail(f"CLI {args[0]} exited {out.returncode}")
    err = out.stderr.splitlines()
    prof = err[err.index("stage profile (wall-clock)"):] if (
        "stage profile (wall-clock)" in err) else []
    summary = [l for l in err if l.startswith(("Reads:", "Called"))]
    return dt, [l for l in prof if l.startswith("  ")], summary


def phase_cli(genome, reads, truth, fused_records):
    from bench import check_accuracy
    from ngsepcore_tpu_torch.vcf.io import VCFFileReader, VCFFileWriter

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _write_inputs(d, genome, reads)
        log(f"phase 8 CLI inputs: {len(reads)} reads -> FASTQ "
            f"({time.perf_counter() - t0:.1f}s)")
        g, fq = os.path.join(d, "genome.fa"), os.path.join(d, "reads.fastq")
        sam, vcf = os.path.join(d, "alns.sam"), os.path.join(d, "calls")
        t_al, prof_al, sum_al = _cli(
            ["ReadsAligner", "-r", g, "-o", sam, "-s", "s1", fq], 900)
        log(f"  ReadsAligner: {t_al:.3f}s = {len(reads) / t_al:.1f} reads/s "
            f"(process wall, start-up included); {'; '.join(sum_al)}")
        for line in prof_al:
            print(f"  align {line.strip()}", flush=True)
        t_vc, prof_vc, sum_vc = _cli(
            ["SingleSampleVariantsDetector", "-r", g, "-i", sam, "-o", vcf,
             "-sampleId", "s1"], 900)
        log(f"  SingleSampleVariantsDetector: {t_vc:.3f}s; {'; '.join(sum_vc)}")
        for line in prof_vc:
            print(f"  call {line.strip()}", flush=True)
        log(f"  classic CLI total {t_al + t_vc:.3f}s = "
            f"{len(reads) / (t_al + t_vc):.1f} reads/s")
        records = VCFFileReader(vcf + ".vcf").load_all()
        with VCFFileWriter(os.path.join(d, "fused.vcf"), ["s1"]) as w:
            for r in fused_records:
                w.write(r)
        body = lambda p: [l for l in open(p) if not l.startswith("#")]
        cli_lines, fused_lines = body(vcf + ".vcf"), body(os.path.join(d, "fused.vcf"))
        n_diff = len(set(cli_lines) ^ set(fused_lines))
        log(f"  {len(records)} records; differing from phase 5's fused "
            f"records: {n_diff} (of {len(cli_lines)} and {len(fused_lines)})")
    acc = check_accuracy(records, *truth)
    log(f"  accuracy: {json.dumps(acc['metrics'])}")
    if acc["gates"]:
        fail("CLI accuracy gates: " + "; ".join(acc["gates"]))
    return t_al, t_vc


# ---------------------------------------------------------------------------
def main() -> None:
    smi = phase_device()
    import torch

    from ngsepcore_tpu_torch.kernels.pairwise_cuda import gotoh_forward_plane
    from ngsepcore_tpu_torch.kernels.shear_pileup import shear_hist

    counters = (gotoh_forward_plane, shear_hist)
    phase_build()
    gotoh_t = phase_gotoh()
    shear_t = phase_shear()
    fused_keys = phase_cuda_vs_cpu(counters)
    launches, _, fused_records, genome, reads, truth = phase_real_size(counters)
    classic_launches = phase_classic(counters, fused_keys)
    phase_span(counters)
    torch.cuda.empty_cache()  # the CLI subprocesses share the card
    phase_cli(genome, reads, truth, fused_records)

    g_ms, g_plain, g_err = gotoh_t["main-path chunk 2048x160x160"]
    c_ms, c_plain, c_err = gotoh_t["classic tier-3 2048x192x192"]
    s_ms, s_plain, s_err = shear_t[1]
    kernels = {
        "kernels": [
            {
                "name": "gotoh_forward",
                "route": "cuda",
                "source": "ngsepcore_tpu_torch/csrc/gotoh_forward.cu",
                "replaces": "ngsepcore_tpu/kernels/pairwise_pallas.py:243",
                "launches": launches["gotoh_forward_plane"],
                "max_abs_err": g_err,
                "ms": g_ms,
                "plain_ms": g_plain,
            },
            {
                # the same kernel on the classic path (phase 6), timed at
                # the classic tier-3 shape
                "name": "gotoh_forward_classic",
                "route": "cuda",
                "source": "ngsepcore_tpu_torch/csrc/gotoh_forward.cu",
                "replaces": "ngsepcore_tpu/kernels/pairwise_pallas.py:243",
                "launches": classic_launches["gotoh_forward_plane"],
                "max_abs_err": c_err,
                "ms": c_ms,
                "plain_ms": c_plain,
            },
            {
                "name": "shear_hist",
                "route": "cuda",
                "source": "ngsepcore_tpu_torch/csrc/shear_hist.cu",
                "replaces": "ngsepcore_tpu/kernels/shear_pileup.py:227",
                "launches": launches["shear_hist"],
                "max_abs_err": s_err,
                "ms": s_ms,
                "plain_ms": s_plain,
            },
        ]
    }
    print(json.dumps(kernels), flush=True)
    print(nvidia_smi() or smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
