"""Markov clustering (MCL) on dense similarity matrices.

Ref: src/ngsep/graphs/MCLJob.java:31-286 — expansion (matrix square) +
inflation (elementwise power, column renormalize) loop until convergence.
Counterpart of ngsepcore_tpu/graphs/mcl.py: the same float32 steps in the
same order on the caller's device, one host read of the largest change an
iteration (the iteration count decides M), attractors read on the host.

MCL's clusters can turn on the last bit of M: where a node sits between two
attractors with nearly equal weights, rounding picks its side.  So every
step here rounds the same way on every device.  Up to EXACT_ORDER_MAX_NODES
nodes (every component of a catalog of orthologs and small families) the
square adds its products in k order, each product exact in float64 and
each partial sum rounded once to float32 (XLA:CPU's float32 dot takes this
order at most of these sizes), and column sums add rows in order in
float32: bit for bit alike on the CPU and the card.  Above it,
the square is a float64 product and the column sums float64 sums, each
rounded once to float32: the devices' BLAS orders then differ only where a
float64 rounding straddles a float32 one.  No float32 product runs, so
TF32 settings cannot reach the expansion.
"""
from __future__ import annotations

import numpy as np
import torch

EXACT_ORDER_MAX_NODES = 64


def _square(M: torch.Tensor) -> torch.Tensor:
    """M @ M in float32, rounded the same way on every device."""
    n = M.shape[0]
    if n > EXACT_ORDER_MAX_NODES:
        return (M.double() @ M.double()).float()
    m = M.double()
    prods = m[:, :, None] * m[None, :, :]  # (i, k, j), exact in float64
    acc = torch.zeros_like(M)
    for k in range(n):
        acc = (acc + prods[:, k, :]).float()
    return acc


def _column_sums(X: torch.Tensor) -> torch.Tensor:
    """X.sum(0, keepdim=True) in float32, rounded the same way on every
    device."""
    n = X.shape[0]
    if n > EXACT_ORDER_MAX_NODES:
        return X.double().sum(dim=0, keepdim=True).float()
    acc = X[0:1]
    for i in range(1, n):
        acc = acc + X[i : i + 1]
    return acc


def mcl_matrix(
    similarity: np.ndarray,
    inflation: float = 2.0,
    max_iters: int = 100,
    tol: float = 1e-6,
    self_loops: float = 1.0,
    *,
    device,
) -> tuple[np.ndarray, int]:
    """The converged float32 matrix M (host numpy) and the iterations run."""
    n = similarity.shape[0]
    M = torch.as_tensor(np.asarray(similarity, np.float32), device=device)
    M = M + self_loops * torch.eye(n, dtype=torch.float32, device=M.device)
    M = M / torch.clamp(_column_sums(M), min=1e-12)
    iters = 0
    for _ in range(max_iters):
        expanded = _square(M)
        inflated = (expanded.double() ** inflation).float()
        new = inflated / torch.clamp(_column_sums(inflated), min=1e-12)
        change = float(torch.max(torch.abs(new - M)))
        M = new
        iters += 1
        if change < tol:
            break
    return M.cpu().numpy(), iters


def mcl_cluster(
    similarity: np.ndarray,
    inflation: float = 2.0,
    max_iters: int = 100,
    tol: float = 1e-6,
    self_loops: float = 1.0,
    *,
    device,
) -> list[list[int]]:
    """Cluster nodes of a weighted graph; returns list of node-index lists.
    `mcl_cluster.calls` and `.iterations` count the calls and iterations."""
    n = similarity.shape[0]
    if n == 0:
        return []
    Mn, iters = mcl_matrix(
        similarity, inflation, max_iters, tol, self_loops, device=device
    )
    mcl_cluster.calls += 1
    mcl_cluster.iterations += iters
    # attractors: rows with significant mass; cluster = attractor row support
    clusters: list[list[int]] = []
    assigned = np.full(n, -1)
    for i in range(n):
        members = np.nonzero(Mn[i] > 1e-4)[0]
        if len(members) == 0:
            continue
        free = [int(m) for m in members if assigned[m] < 0]
        if not free:
            continue
        cid = len(clusters)
        for m in free:
            assigned[m] = cid
        clusters.append(free)
    for i in range(n):
        if assigned[i] < 0:
            assigned[i] = len(clusters)
            clusters.append([i])
    return clusters


mcl_cluster.calls = 0
mcl_cluster.iterations = 0
