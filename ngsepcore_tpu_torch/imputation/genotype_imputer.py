"""Genotype imputation with a haplotype-cluster HMM (fastPHASE family).

Ref: src/ngsep/variants/imputation/GenotypeImputer.java (command
`VCFImpute`; defaults k=8 haplotype clusters, window 5000 sites, overlap
50, avgCMPerKbp 0.001 at :52-55), GenotypeImputationHMM.java /
DiploidGenotypeImputationHMM.java (k^2 product states),
HaplotypeClusterHMMState.java:30-80 (emission 0.99/0.01 with GQ-scaled
success prob), RecombinationHMM.java:51-67 (per-interval switch
probability from physical distance), trained by Baum-Welch
(AbstractHMM.java Baum-Welch consts).

Counterpart of ngsepcore_tpu/imputation/genotype_imputer.py.  One dense
(samples, sites) dosage matrix a window; the emissions of every sample are
built on the device at once, the E-step is one `posterior_log_batch` call
(csrc/forward_backward.cu on CUDA tensors), and the M-step updates the
cluster allele-frequency matrix theta (sites, k) from the batched
posteriors by two einsums on the device.  The start values of theta, the
transitions and the final genotype decision are host numpy, as in the JAX
package, so that the same seed draws the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.hmm import posterior_log_batch
from ..math.phred import phred_score
from ..vcf.io import VCFFileReader, VCFFileWriter

DEF_NUM_HAPLOTYPE_CLUSTERS = 8  # ref: GenotypeImputer.java:52
DEF_WINDOW_SIZE = 5000  # ref :53
DEF_OVERLAP = 50  # ref :54
DEF_AVG_CM_PER_KBP = 0.001  # ref :55
GENO_ERROR = 0.01  # ref: HaplotypeClusterHMMState LOGPROB_UNEXPECTED=log10(0.01)


def _genotype_probs(theta):
    """P(dosage 0 | k1, k2), P(1 | ...), P(2 | ...): three (T, K, K) arrays
    from theta (T, K), numpy or torch."""
    t1 = theta[:, :, None]
    t2 = theta[:, None, :]
    p0 = (1 - t1) * (1 - t2)
    p1 = t1 * (1 - t2) + (1 - t1) * t2
    p2 = t1 * t2
    return p0, p1, p2


def _diploid_emissions(theta: torch.Tensor, dosages: torch.Tensor) -> torch.Tensor:
    """log10 emissions of every sample: theta (T, K) f64 allele-1
    frequency per cluster, dosages (n, T) int8 with 0/1/2 and -1 for
    missing, on one device.  Returns (n, T, K*K)."""
    T, K = theta.shape
    probs = torch.stack(_genotype_probs(theta), dim=-1)  # (T, K, K, 3)
    obs = torch.where(dosages < 0, 0, dosages).long()  # (n, T)
    # the probability of the observed dosage (the JAX package's one-hot
    # einsum adds exact zeros to it)
    lik = probs[torch.arange(T, device=theta.device)[None, :], :, :, obs]  # (n, T, K, K)
    e = GENO_ERROR
    lik = (1 - e) * lik + e / 3.0
    lik = torch.where(dosages[:, :, None, None] < 0, 1.0, lik)
    return torch.log10(lik).reshape(dosages.shape[0], T, K * K)


def _transition_matrix(recomb_p: np.ndarray, K: int) -> np.ndarray:
    """Per-interval diploid transitions: kron of haploid switch models.

    Haploid: (1-p)·I + p/K (uniform jump; ref RecombinationHMM).
    """
    T1 = len(recomb_p)
    eye = np.eye(K)
    out = np.empty((T1, K * K, K * K))
    for t in range(T1):
        p = recomb_p[t]
        H = (1 - p) * eye + p / K
        out[t] = np.kron(H, H)
    with np.errstate(divide="ignore"):
        return np.log10(out)


class GenotypeImputer:
    def __init__(
        self,
        k: int = DEF_NUM_HAPLOTYPE_CLUSTERS,
        window_size: int = DEF_WINDOW_SIZE,
        overlap: int = DEF_OVERLAP,
        avg_cm_per_kbp: float = DEF_AVG_CM_PER_KBP,
        n_iterations: int = 10,
        seed: int = 1,
        *,
        device,
    ):
        self.k = k
        self.window_size = window_size
        self.overlap = overlap
        self.avg_cm_per_kbp = avg_cm_per_kbp
        self.n_iterations = n_iterations
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def impute_matrix(
        self, dosages: np.ndarray, positions: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Impute a (samples, sites) dosage matrix (-1 = missing).

        Returns (imputed dosages, posterior probability of the chosen
        genotype).  Sites are processed in overlapping windows; overlap
        region keeps the later window's calls (ref streaming re-emit).
        """
        n, T = dosages.shape
        out = dosages.copy()
        conf = np.ones((n, T))
        step = self.window_size - self.overlap
        for w0 in range(0, T, step):
            w1 = min(T, w0 + self.window_size)
            di, ci = self._impute_window(dosages[:, w0:w1], positions[w0:w1])
            out[:, w0:w1] = di
            conf[:, w0:w1] = ci
            if w1 >= T:
                break
        return out, conf

    # ------------------------------------------------------------------
    def e_step(self, theta: torch.Tensor, dos: torch.Tensor, log_start, log_trans):
        """Posteriors (n, T, K*K) in linear space and the summed
        log-likelihood: one posterior_log_batch call for every sample."""
        post_log, lls = posterior_log_batch(log_start, log_trans, _diploid_emissions(theta, dos))
        return torch.pow(10.0, post_log), torch.sum(lls)

    def m_step(self, post: torch.Tensor, theta: torch.Tensor, dos: torch.Tensor) -> torch.Tensor:
        """theta from the posteriors: expected allele-1 content per cluster
        slot; for state (k1, k2) and genotype g, E[a1 | g, k1, k2]
        (symmetric for a2).  Missing sites do not update theta."""
        K = self.k
        pk = post.reshape(post.shape[0], post.shape[1], K, K)
        t1 = theta[:, :, None]  # (T, K, 1)
        t2 = theta[:, None, :]
        p_het = t1 * (1 - t2) + (1 - t1) * t2
        ea1_het = t1 * (1 - t2) / torch.clamp(p_het, min=1e-12)  # (T, K, K)
        g1 = (dos == 1)[:, :, None, None]
        g2 = (dos == 2)[:, :, None, None]
        miss = (dos < 0)[:, :, None, None]
        zero = torch.zeros((), dtype=theta.dtype, device=theta.device)
        ea1 = torch.where(
            g2, 1.0, torch.where(g1, ea1_het[None], torch.where(miss, t1[None], zero))
        )
        ea2 = torch.where(
            g2, 1.0,
            torch.where(g1, 1.0 - ea1_het[None], torch.where(miss, t2[None], zero)),
        )
        w = torch.where(miss, zero, pk)
        num = torch.einsum("ntkl,ntkl->tk", w, ea1) + torch.einsum("ntkl,ntkl->tl", w, ea2)
        den = torch.sum(w, dim=(0, 3)) + torch.sum(w, dim=(0, 2))
        return torch.clamp(num / torch.clamp(den, min=1e-9), 1e-3, 1 - 1e-3)

    def window_model(self, positions: np.ndarray):
        """(log_start (K*K,), log_trans (T-1, K*K, K*K)) of a window on the
        device: transitions from the physical distances (ref :51-67), built
        on the host and uploaded."""
        K = self.k
        d_kbp = np.maximum(np.diff(positions), 1) / 1000.0
        d_morgans = self.avg_cm_per_kbp * d_kbp / 100.0
        recomb_p = np.clip(1.0 - np.exp(-d_morgans), 1e-6, 0.49)
        log_trans = torch.from_numpy(_transition_matrix(recomb_p, K)).to(self.device)
        log_start = torch.full((K * K,), -np.log10(K * K), dtype=torch.float64,
                               device=self.device)
        return log_start, log_trans

    def posteriors_to_host(self, post: torch.Tensor) -> np.ndarray:
        """The last E-step's posteriors (n, T, K*K) as a host array."""
        return post.cpu().numpy()

    def genotype_posteriors(self, post: np.ndarray, theta: np.ndarray) -> np.ndarray:
        """P(g) = sum over states of post * P(g | state): (n, T, 3) on the
        host."""
        T, K = theta.shape
        pg = np.stack(_genotype_probs(theta), axis=-1).reshape(T, K * K, 3)
        return np.einsum("nts,tsg->ntg", post, pg)

    def _impute_window(self, dosages: np.ndarray, positions: np.ndarray):
        n, T = dosages.shape
        K = self.k
        dev = self.device
        theta = np.clip(self.rng.uniform(0.05, 0.95, size=(T, K)), 1e-3, 1 - 1e-3)
        # initialize clusters near observed allele frequencies
        with np.errstate(invalid="ignore"):
            af = np.nanmean(np.where(dosages < 0, np.nan, dosages), axis=0) / 2.0
        af = np.nan_to_num(af, nan=0.5)
        theta = 0.5 * theta + 0.5 * af[:, None]
        log_start, log_trans = self.window_model(positions)

        dos = torch.from_numpy(np.ascontiguousarray(dosages, dtype=np.int8)).to(dev)
        theta_d = torch.from_numpy(theta).to(dev)
        for _ in range(self.n_iterations):
            post, _ = self.e_step(theta_d, dos, log_start, log_trans)
            theta_d = self.m_step(post, theta_d, dos)
            del post

        post, _ = self.e_step(theta_d, dos, log_start, log_trans)
        post = self.posteriors_to_host(post)  # (n, T, K*K)
        geno_post = self.genotype_posteriors(post, theta_d.cpu().numpy())
        best = np.argmax(geno_post, axis=2).astype(np.int8)
        best_p = np.take_along_axis(geno_post, best[:, :, None].astype(int), axis=2)[
            :, :, 0
        ]
        out = np.where(dosages < 0, best, dosages)
        return out, best_p

    # ------------------------------------------------------------------
    def run(self, input_vcf: str, output_prefix: str) -> None:
        """CLI surface: impute undecided genotypes of biallelic SNVs."""
        reader = VCFFileReader(input_vcf)
        records = reader.load_all()
        sample_ids = reader.sample_ids
        snv_idx = [
            i
            for i, r in enumerate(records)
            if r.variant.is_snv and r.variant.is_biallelic
        ]
        by_seq: dict[str, list[int]] = {}
        for i in snv_idx:
            by_seq.setdefault(records[i].variant.sequence_name, []).append(i)
        for seq, idxs in by_seq.items():
            T = len(idxs)
            n = len(sample_ids)
            dosages = np.full((n, T), -1, np.int8)
            positions = np.array([records[i].variant.first for i in idxs])
            for t, i in enumerate(idxs):
                for s, call in enumerate(records[i].calls):
                    if not call.is_undecided:
                        dosages[s, t] = sum(
                            1 for a in call.indexes_called_alleles if a == 1
                        ) * (2 // max(1, len(call.indexes_called_alleles)))
            imputed, conf = self.impute_matrix(dosages, positions)
            for t, i in enumerate(idxs):
                for s, call in enumerate(records[i].calls):
                    if call.is_undecided and dosages[s, t] < 0:
                        g = int(imputed[s, t])
                        call.indexes_called_alleles = (
                            [0, 0] if g == 0 else ([0, 1] if g == 1 else [1, 1])
                        )
                        call.genotype_quality = phred_score(
                            max(0.0, 1.0 - float(conf[s, t]))
                        )
        with VCFFileWriter(output_prefix + "_imputed.vcf", sample_ids) as w:
            for r in records:
                w.write(r)
