"""Per-variant linear-model association test.

Ref: src/ngsep/gwas/GeneralLinearModel.java (143 LoC, standalone main):
ordinary least squares of phenotype on genotype dosage per site with an
F-test p-value.

Counterpart of ngsepcore_tpu/gwas/glm.py.  The per-site moments (n, means,
variance, covariance, residual and total sums of squares) of every site
are computed at once in float64 on the caller's device over the (sites,
samples) dosage matrix, each site over its own samples (genotyped, with a
phenotype); the F distribution's tail (_f_sf, _betainc) is a host scalar
per kept site, copied.  A site is kept as the JAX package keeps it: at
least 3 samples, a dosage that varies, a phenotype that varies.  Values
agree with the JAX package's to rounding (sums in another order).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..vcf.analytics import dosage_matrix
from ..vcf.io import VCFRecord


def _f_sf(f: float, d1: int, d2: int) -> float:
    """Survival function of the F distribution via the regularized
    incomplete beta function (continued-fraction evaluation)."""
    if f <= 0:
        return 1.0
    x = d2 / (d2 + d1 * f)
    return _betainc(d2 / 2.0, d1 / 2.0, x)


def _betainc(a: float, b: float, x: float) -> float:
    if x <= 0:
        return 0.0
    if x >= 1:
        return 1.0
    lbeta = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    front = math.exp(a * math.log(x) + b * math.log(1 - x) - lbeta) / a
    # Lentz continued fraction
    f, c, d = 1.0, 1.0, 0.0
    for i in range(200):
        m = i // 2
        if i == 0:
            num = 1.0
        elif i % 2 == 0:
            num = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        else:
            num = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        d = 1.0 + num * d
        if abs(d) < 1e-30:
            d = 1e-30
        d = 1.0 / d
        c = 1.0 + num / c
        if abs(c) < 1e-30:
            c = 1e-30
        f *= c * d
        if abs(1.0 - c * d) < 1e-10:
            break
    val = front * (f - 1.0)
    return min(1.0, max(0.0, val)) if x < (a + 1) / (a + b + 2) else 1.0 - _betainc(b, a, 1 - x)


def site_moments(dos: np.ndarray, y: np.ndarray, *, device) -> dict:
    """Per-site OLS moments of phenotype y (samples,) on the dosages dos
    (sites, samples; -1 missing, NaN phenotypes left out), float64 on
    `device`: {n, var_x, beta, ss_res, ss_tot} as host arrays."""
    x = torch.as_tensor(dos, device=device).to(torch.float64)
    yt = torch.as_tensor(y, dtype=torch.float64, device=device)
    m = ((x >= 0) & ~torch.isnan(yt)[None, :]).to(torch.float64)
    y0 = torch.nan_to_num(yt)[None, :]
    n = m.sum(dim=1)
    nz = n.clamp(min=1)
    xm = (x * m).sum(dim=1) / nz
    ym = (y0 * m).sum(dim=1) / nz
    dx = (x - xm[:, None]) * m
    dy = (y0 - ym[:, None]) * m
    var_x = (dx * dx).sum(dim=1) / nz
    cov = (dx * dy).sum(dim=1) / nz
    beta = cov / torch.where(var_x == 0, 1.0, var_x)
    alpha = ym - beta * xm
    resid = (y0 - (alpha[:, None] + beta[:, None] * x)) * m
    out = {
        "n": n,
        "var_x": var_x,
        "beta": beta,
        "ss_res": (resid * resid).sum(dim=1),
        "ss_tot": (dy * dy).sum(dim=1),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


class GeneralLinearModel:
    def __init__(self, *, device):
        self.device = torch.device(device)

    def run_association(
        self, records: list[VCFRecord], phenotypes: dict[str, float]
    ) -> list[dict]:
        recs = [r for r in records if r.variant.is_snv and r.variant.is_biallelic]
        if not recs:
            return []
        dos, samples = dosage_matrix(recs)
        y = np.array([phenotypes.get(s, np.nan) for s in samples], dtype=np.float64)
        mom = site_moments(dos, y, device=self.device)
        out = []
        for i, r in enumerate(recs):
            n = int(mom["n"][i])
            if n < 3 or mom["var_x"][i] == 0:
                continue
            ss_res, ss_tot = float(mom["ss_res"][i]), float(mom["ss_tot"][i])
            if ss_tot <= 0:
                continue
            r2 = 1 - ss_res / ss_tot
            df2 = n - 2
            fstat = r2 / max(1e-12, (1 - r2)) * df2
            pval = _f_sf(fstat, 1, df2)
            out.append(
                {
                    "sequence": r.variant.sequence_name,
                    "position": r.variant.first,
                    "beta": float(mom["beta"][i]),
                    "r2": float(r2),
                    "f": float(fstat),
                    "p": float(pval),
                    "n": n,
                }
            )
        return out
