"""A mesh of torch devices on one axis, `reads`, and the data-parallel
align + genotype step over it (ngsepcore_tpu/distribute/mesh.py).

The JAX package runs one process over a `jax.sharding.Mesh` with
`shard_map`.  Here one process holds an ordered tuple of torch devices;
entry 0 is the lead device, where merged outputs live.  An entry may
repeat: ["cuda:0"] * 4 is four shards of one card, each on its own CUDA
stream, and ["cpu"] * 8 is what the CPU tests run, the counterpart of the
JAX tests' eight virtual CPU devices.  Shards on one card check the
partition of the work, the merges, the per-shard launches and the
ordering between streams; they are not a scaling claim.  On a machine
with several cards make_reads_mesh(n, device="cuda") puts shard i on
cuda:i.

Ordering on CUDA (ReadsMesh.shard, ReadsMesh.join): a shard's stream waits
on the lead device's current stream, and on its own device's, before it
reads anything made there; the current streams wait on every shard stream
before a merge reads the shards' outputs.  Tensors read on another stream
than the one that made them are marked with record_stream, so the caching
allocator does not hand their memory out while that stream still reads
it.  Host syncs inside a shard (a .cpu(), a nonzero) serialise the shards:
the mesh counts them (torch.cuda.set_sync_debug_mode) beside each shard's
kernel launches.
"""
from __future__ import annotations

import warnings
import weakref
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from ..kernels.genotyping import (
    MAX_BASE_QS,
    MIN_BASE_QS,
    N_QBINS,
    genotype_posteriors,
)
from ..kernels.pairwise import _runs_from_plane, affine_gap_align_batch
from ..kernels.pairwise_cuda import gotoh_forward_plane
from ..kernels.tier1 import tier1_stats


def _launch_counts() -> dict:
    """Launches so far of the kernels a shard can reach."""
    return {
        "gotoh_forward": gotoh_forward_plane.launches,
        "run_walk": _runs_from_plane.launches,
    }


def _mesh_device(d) -> torch.device:
    """torch.device of a mesh entry, CUDA ones with their index; raises
    for a card that is not there."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh entry {d}: no CUDA device is visible")
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh entry {d}: {torch.cuda.device_count()} CUDA devices are visible"
            )
        d = torch.device("cuda", index)
    elif d.type != "cpu":
        raise ValueError(f"mesh entry {d}: only cpu and cuda devices")
    return d


class ReadsMesh:
    """An ordered tuple of torch devices on the axis `reads` (the
    counterpart of jax.sharding.Mesh(devices, ("reads",))).

    devices: the shards' devices, entry 0 the lead.  streams: one CUDA
    stream a CUDA shard (None for a CPU one), made once.  distinct: each
    device once, in mesh order: what holds one replica.  launches[ax]:
    kernel launches made inside shard ax's work; host_syncs[ax]: host
    syncs there (CUDA only)."""

    def __init__(self, devices):
        devs = tuple(_mesh_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devs
        )
        self.distinct = tuple(dict.fromkeys(devs))
        self.launches = [Counter() for _ in devs]
        self.host_syncs = [0] * len(devs)
        self._replicas: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def blocks(self, n: int) -> list[tuple[int, int]]:
        """Contiguous [a, b) blocks of n items, one a shard in rank order,
        the first n % size one longer (np.array_split's)."""
        edges = np.cumsum([0] + [len(p) for p in np.array_split(np.arange(n), self.size)])
        return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]

    # ---- placement --------------------------------------------------------
    def replicate(self, t: torch.Tensor) -> dict:
        """{device: copy of t} over the mesh's distinct devices, t itself on
        its own device: one copy a card, not one a shard.  Made once for a
        tensor while it lives; call it outside a shard's work, so a copy is
        ordered on its device's current stream, which every shard stream
        of that device waits on."""
        hit = self._replicas.get(id(t))
        if hit is None or hit[0]() is not t:
            # the memo holds the copies, never t: they go once t has gone
            self._replicas = {k: v for k, v in self._replicas.items() if v[0]() is not None}
            hit = (weakref.ref(t), {d: t.to(d) for d in self.distinct if d != t.device})
            self._replicas[id(t)] = hit
        return {d: hit[1].get(d, t) for d in self.distinct}

    def take(self, ax: int, t: torch.Tensor) -> torch.Tensor:
        """t on shard ax's device, for reading in its work (inside
        shard(ax)): copied there if it lies elsewhere, else marked as read
        on the shard's stream."""
        d = self.devices[ax]
        if t.device != d:
            return t.to(d)
        if self.streams[ax] is not None:
            t.record_stream(self.streams[ax])
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """A shard's output on the lead device, after join(): marked as read
        on the current stream of the device it lies on."""
        if t.device.type == "cuda":
            t.record_stream(torch.cuda.current_stream(t.device))
        return t if t.device == self.lead else t.to(self.lead)

    # ---- ordering -------------------------------------------------------------
    @contextmanager
    def shard(self, ax: int):
        """The work of shard ax: on a CUDA shard, its device and stream
        current, after the stream waited on the lead's and its device's
        current streams; its kernel launches and host syncs counted."""
        d, s = self.devices[ax], self.streams[ax]
        before = _launch_counts()
        if s is None:
            try:
                yield d
            finally:
                self._count_launches(ax, before)
            return
        s.wait_stream(torch.cuda.current_stream(self.lead))
        if d != self.lead:
            s.wait_stream(torch.cuda.current_stream(d))
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.cuda.device(d), torch.cuda.stream(s):
                    yield d
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                self._count_launches(ax, before)
        self.host_syncs[ax] += sum(
            "synchronizing" in str(w.message) for w in caught
        )

    def _count_launches(self, ax: int, before: dict) -> None:
        for k, v in _launch_counts().items():
            self.launches[ax][k] += v - before[k]

    def join(self) -> None:
        """Make the lead's and every shard device's current stream wait on
        the shard streams: after this, work there may read the shards'
        outputs."""
        for d, s in zip(self.devices, self.streams):
            if s is None:
                continue
            torch.cuda.current_stream(self.lead).wait_stream(s)
            if d != self.lead:
                torch.cuda.current_stream(d).wait_stream(s)


def make_reads_mesh(n_devices: int | None = None, devices=None, *, device=None) -> ReadsMesh:
    """A mesh on the axis `reads`.

    devices: the mesh's entries as given, repeats included (["cuda:0"] * 4,
    ["cpu"] * 8).  Else device: "cuda" takes the first n_devices visible
    cards (all of them when None) and raises when there are fewer; "cpu"
    gives n_devices CPU shards.  A mesh never puts two shards on one card
    unless its entries say so, and never falls back to the CPU."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} but {len(devices)} devices given")
        return ReadsMesh(devices)
    if device is None:
        raise ValueError("make_reads_mesh needs devices or device")
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n < 1 or n > have:
            raise RuntimeError(f"a mesh of {n} CUDA devices: {have} visible")
        return ReadsMesh([torch.device("cuda", i) for i in range(n)])
    if kind == "cpu":
        return ReadsMesh(["cpu"] * (1 if n_devices is None else n_devices))
    raise ValueError(f"unsupported device {device}")


def _ungapped_counts(reads, qlens, quals, win_off, window_size: int):
    """(window, 4, N_QBINS) int32 counts of the ungapped allele calls:
    read base b at window position win_off + i, for i below the read's
    length, an ACGT base and a quality above MIN_BASE_QS."""
    dev = reads.device
    B, L = reads.shape
    i = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    pos = win_off.to(torch.int64)[:, None] + i
    r = reads.to(torch.int64)
    qv = quals.to(torch.int64)
    valid = (i < qlens.to(torch.int64)[:, None]) & (r >= 0) & (r < 4)
    ok = valid & (qv > MIN_BASE_QS) & (pos >= 0) & (pos < window_size)
    cell = torch.where(ok, pos, 0) * 4 + torch.where(valid, r, 0)
    counts = torch.zeros((window_size, 4, N_QBINS), dtype=torch.int32, device=dev)
    counts.view(-1).index_add_(
        0, (cell * N_QBINS + torch.clamp(qv, 0, MAX_BASE_QS)).reshape(-1),
        ok.to(torch.int32).reshape(-1),
    )
    return counts


def sharded_call_step(mesh: ReadsMesh, window_size: int, contribution):
    """The data-parallel align + genotype step over `mesh`.

    step(reads, qlens, subjects, slens, quals, win_off) takes (B, L) int8
    read codes and subject windows, (B,) lengths, (B, L) qualities and
    (B,) window offsets (numpy or tensors).  Shard ax takes row block ax
    (ReadsMesh.blocks) and, on its device and stream, runs the tier-1
    screen (tier1_stats), the affine-gap DP with free subject ends
    (affine_gap_align_batch: the Gotoh kernel and the walk on the card) and
    the scatter of its ungapped allele calls into (window, 4, N_QBINS)
    int32 counts.  The counts are summed on the lead device in rank order
    (the JAX package's psum; integer sums are exact in any order) and
    genotype_posteriors runs on the sum.  Returns (DP scores, tier-1
    mismatch counts, merged counts, posteriors), scores and mismatches
    concatenated in rank order."""
    contrib = torch.as_tensor(np.asarray(contribution, np.float64)).to(mesh.lead)

    def step(reads, qlens, subjects, slens, quals, win_off):
        args = [torch.as_tensor(a).to(mesh.lead)
                for a in (reads, qlens, subjects, slens, quals, win_off)]
        args[0] = args[0].to(torch.int8)
        args[2] = args[2].to(torch.int8)
        outs = []
        for ax, (a, b) in enumerate(mesh.blocks(args[0].shape[0])):
            if a == b:
                continue
            with mesh.shard(ax):
                r, ql, s, sl, q, wo = (mesh.take(ax, x[a:b]) for x in args)
                total_mm, _, _ = tier1_stats(r, ql, s)
                dp = affine_gap_align_batch(r, ql, s, sl, free_start2=True, free_end2=True)
                outs.append((dp["score"], total_mm, _ungapped_counts(r, ql, q, wo, window_size)))
        mesh.join()
        counts = mesh.gather(outs[0][2]).clone()
        for o in outs[1:]:
            counts += mesh.gather(o[2])
        post, _ = genotype_posteriors(counts, contrib)
        score = torch.cat([mesh.gather(o[0]) for o in outs])
        total_mm = torch.cat([mesh.gather(o[1]) for o in outs])
        return score, total_mm, counts, post

    return step
