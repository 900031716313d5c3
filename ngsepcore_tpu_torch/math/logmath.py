"""Log10-space probability math.

Ref: src/ngsep/math/LogMath.java:38-89.  The reference works in log10 (not
ln) throughout its genotype-likelihood model; we keep that convention for
output parity.  Both numpy (host) and torch (device) variants are provided.
"""
from __future__ import annotations

import numpy as np
import torch

def log10_sum(log_a, log_b):
    """log10(10^a + 10^b), None-safe like the reference's logSum.

    Ref: LogMath.java logSum (null treated as probability 0).
    """
    if log_a is None:
        return log_b
    if log_b is None:
        return log_a
    if log_a < log_b:
        log_a, log_b = log_b, log_a
    diff = log_b - log_a
    if diff < -20:
        return log_a
    return log_a + np.log10(1.0 + 10.0 ** diff)


def torch_log10_sum(log_values: torch.Tensor, dim=None, keepdim=False):
    """Device log10-sum-exp (torch), safe against -inf rows."""
    if dim is None:
        log_values = log_values.reshape(-1)
        dim = 0
    m = torch.amax(log_values, dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.pow(10.0, log_values - m_safe), dim=dim, keepdim=True)
    out = m_safe + torch.log10(s)
    out = torch.where(torch.isfinite(m), out, m)
    if not keepdim:
        out = out.squeeze(dim)
    return out
