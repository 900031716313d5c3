"""The fused align + call pipeline over a mesh of devices
(ngsepcore_tpu/distribute/pipeline.py).

One mesh axis, `reads` (distribute/mesh.py): read batches are split into
contiguous row blocks, one a shard, for seeding; the minimizer index and
the packed genome are replicated once on each distinct device of the
mesh; the tier-3 DP is split along its jobs (make_sharded_dp_run_all);
window genotyping is split along the window (make_sharded_span_kernel):
shard ax scatters only the reads that reach its window / D positions
and genotypes them, and the merged sites are the unsharded kernel's.
Every per-position result comes from the same reads whatever the mesh,
so the records are those of the unsharded pipeline at any mesh size
(tests/test_torch_distribute.py holds them to the JAX package's at 1, 2
and 8 shards).

Left out of the JAX design: its static-shape machinery (rows_shard, the
span_overflow fallback to the unsharded kernel, max_flag / max_out) and
its padding of the chunk count to a multiple of D.  Each shard takes
every row of its span and its own number of chunks.  A mesh size that
does not divide the window raises (the JAX kernel drops the tail
positions).
"""
from __future__ import annotations

import numpy as np
import torch

from ..call.fused_pipeline import AlignCallPipeline
from ..kernels.genotyping import (
    META_CE,
    META_CS,
    META_LEN,
    META_PRED,
    META_STRAND,
    N_COLS,
    _screened_sites,
    _span_packed_scatter,
    _span_scatter_counts,
)
from ..kernels.pairwise import dp_run_all
from ..kernels.seeding import seed_cluster_screen
from .mesh import ReadsMesh

_SITE_FIELDS = (
    "site_idx", "bi", "bj", "gq", "ref_prob", "depths", "total", "logcond",
    "strand_counts",
)


def make_sharded_dp_run_all(mesh: ReadsMesh):
    """kernels/pairwise.dp_run_all split along the jobs axis: shard ax
    runs a contiguous block of the CH-row chunks (ReadsMesh.blocks) on its
    device and stream against bigpq, lengths and the genome's concat, put
    once on each distinct device.  Same signature and outputs as
    dp_run_all: the stats with a leading chunk axis, in chunk order on
    the lead device."""

    def run(bigpq, lengths, concat, rows, strand, firsts, slen,
            *, CH: int, Lq: int, Ls: int, n_chunks: int):
        reps = [mesh.replicate(t) for t in (bigpq, lengths, concat)]
        outs = []
        for ax, (c0, c1) in enumerate(mesh.blocks(n_chunks)):
            if c0 == c1:
                continue
            d = mesh.devices[ax]
            s = slice(c0 * CH, c1 * CH)
            with mesh.shard(ax):
                outs.append(dp_run_all(
                    *(mesh.take(ax, r[d]) for r in reps),
                    *(mesh.take(ax, t[s]) for t in (rows, strand, firsts, slen)),
                    CH=CH, Lq=Lq, Ls=Ls, n_chunks=c1 - c0,
                ))
        mesh.join()
        return {k: torch.cat([mesh.gather(o[k]) for o in outs]) for k in outs[0]}

    return run


def make_sharded_span_kernel(mesh: ReadsMesh):
    """kernels/genotyping.genotype_window_span split along the window.

    Same signature and outputs.  The window splits into D chunks of
    out_size // D positions; D must divide out_size (ValueError
    otherwise).  Shard ax takes the rows of the sorted pred column in
    [w0 + ax*chunk - Lp, w0 + (ax+1)*chunk) (one searchsorted on the lead
    device for every shard), scatters them (_span_scatter_counts) and the
    packed host calls whose position lies in its chunk, rebased
    (_span_packed_scatter), screens its chunk against its slice of the
    reference codes (_screened_sites) and adds ax*chunk to its site
    indices.  A read within Lp of a chunk edge is scattered by both
    neighbours and each counts only its own positions, so the counts are
    the unsharded ones.  The merge concatenates the chunks' sites in chunk
    order; n_sites and n_flagged are sums over the chunks."""
    D = mesh.size

    def kernel(pq, meta, start, count, w0, packed, ref_codes, contribution,
               het_rate, min_quality, *, out_size: int, n_alleles: int = 4):
        if out_size % D:
            raise ValueError(
                f"a mesh of {D} shards does not divide the window of {out_size} positions"
            )
        chunk = out_size // D
        lo = hi = [0] * D
        if count:
            Lp = pq.shape[1]
            pred = meta[start : start + count, META_PRED].contiguous()
            a0 = w0 + chunk * np.arange(D)
            edges = torch.from_numpy(np.concatenate([a0 - Lp, a0 + chunk])).to(pred)
            bnd = (torch.searchsorted(pred, edges) + start).tolist()
            lo, hi = bnd[:D], bnd[D:]
            pq_r, meta_r = mesh.replicate(pq), mesh.replicate(meta)
        pk_r, ref_r, c_r = (mesh.replicate(t) for t in (packed, ref_codes, contribution))
        results = []
        for ax in range(D):
            d = mesh.devices[ax]
            a0 = ax * chunk
            with mesh.shard(ax):
                counts128 = torch.zeros((chunk, N_COLS), dtype=torch.int32, device=d)
                strand_flat = torch.zeros(chunk * 8, dtype=torch.int32, device=d)
                if hi[ax] > lo[ax]:
                    sl = mesh.take(ax, pq_r[d])[lo[ax] : hi[ax]]
                    mt = mesh.take(ax, meta_r[d])[lo[ax] : hi[ax]]
                    _span_scatter_counts(
                        counts128, strand_flat, sl & 7, sl >> 3, mt[:, META_LEN],
                        mt[:, META_PRED] - (w0 + a0), mt[:, META_CS], mt[:, META_CE],
                        mt[:, META_STRAND],
                    )
                pk = mesh.take(ax, pk_r[d])
                if pk.numel():
                    # the position is the low 20 bits: rebasing a call of this
                    # chunk never borrows from its flag bits
                    rel = pk & 0xFFFFF
                    mine = (pk >= 0) & (rel >= a0) & (rel < a0 + chunk)
                    _span_packed_scatter(
                        counts128, strand_flat, torch.where(mine, pk - a0, -1)
                    )
                total = counts128.sum(dim=1, dtype=torch.int32)
                res = _screened_sites(
                    counts128, strand_flat.view(-1, 8), total, total,
                    mesh.take(ax, ref_r[d])[a0 : a0 + chunk], mesh.take(ax, c_r[d]),
                    het_rate, min_quality, n_alleles,
                )
                res["site_idx"] = res["site_idx"] + a0
            results.append(res)
        mesh.join()
        merged = {
            k: torch.cat([mesh.gather(r[k]) for r in results]) for k in _SITE_FIELDS
        }
        merged["n_sites"] = sum(r["n_sites"] for r in results)
        merged["n_flagged"] = sum(r["n_flagged"] for r in results)
        return merged

    return kernel


class ShardedAlignCallPipeline(AlignCallPipeline):
    """AlignCallPipeline over a ReadsMesh (the mesh's lead device is the
    pipeline's device).

    - the minimizer table's device arrays and the packed genome are put
      once on each distinct device of the mesh: one copy a card;
    - each read batch is uploaded as D contiguous row blocks, one on each
      shard's device, and seed_cluster_screen runs per block on the
      shard's stream (its work is per row; const_len is the whole
      batch's); the blocks' outputs and the batch matrix are concatenated
      on the lead device in row order, where classification, selection
      and compaction run unchanged;
    - tier 3 runs through make_sharded_dp_run_all;
    - genotyping always takes the span path with make_sharded_span_kernel
      (the JAX package's pipeline does the same under a mesh).

    The records equal the unsharded pipeline's at any mesh size."""

    def __init__(self, genome, aligner=None, detector=None,
                 batch_size: int = 32768, *, mesh: ReadsMesh):
        super().__init__(
            genome, aligner=aligner, detector=detector, batch_size=batch_size,
            device=mesh.lead,
        )
        self.mesh = mesh
        for d in mesh.distinct:
            self.aligner.table.device_arrays(d)
            self.genome.device_packed(d)
            self.genome.device_concat(d)
        self._span_kernel = make_sharded_span_kernel(mesh)
        self.aligner.dp_run_all_fn = make_sharded_dp_run_all(mesh)

    # ---- mesh seams of AlignCallPipeline ------------------------------------
    def _put_reads(self, pq: np.ndarray) -> tuple[torch.Tensor, ...]:
        """The batch's contiguous row blocks, block ax on shard ax's device."""
        return tuple(
            torch.from_numpy(pq[a:b]).to(self.mesh.devices[ax])
            for ax, (a, b) in enumerate(self.mesh.blocks(pq.shape[0]))
        )

    # the two below put the copies on each device at upload, as the JAX
    # package does; the sharded functions find them (ReadsMesh.replicate)
    def _device_put_repl(self, x: np.ndarray) -> torch.Tensor:
        t = super()._device_put_repl(x)
        self.mesh.replicate(t)
        return t

    def _prepare_tier3_arrays(self, bigpq, lengths_dev):
        self.mesh.replicate(bigpq)
        self.mesh.replicate(lengths_dev)
        return bigpq, lengths_dev

    def _seed_screen(self, pq_dev: tuple[torch.Tensor, ...], lengths_h, const_len):
        al = self.aligner
        mesh = self.mesh
        outs = []
        for ax, ((a, b), blk) in enumerate(zip(mesh.blocks(len(lengths_h)), pq_dev)):
            if a == b:
                continue
            d = mesh.devices[ax]
            ln = torch.from_numpy(lengths_h[a:b]).to(d)
            gp, gn2 = self.genome.device_packed(d)
            with mesh.shard(ax):
                outs.append(seed_cluster_screen(
                    mesh.take(ax, blk), mesh.take(ax, ln),
                    al.table.device_arrays(d), gp, gn2,
                    k=al.kmer_length,
                    window=al.window_length,
                    genome_len=self.genome.total_length,
                    const_len=const_len,
                    genome_has_n=self.genome.has_n,
                ))
        mesh.join()
        pq_lead = torch.cat([mesh.gather(t) for t in pq_dev])
        res = {k: torch.cat([mesh.gather(o[k]) for o in outs]) for k in outs[0]}
        return pq_lead, torch.from_numpy(lengths_h).to(self.device), res

    def _genotype(self, batches, host):
        return self._genotype_span(batches, host)
