"""K-mer count map as sorted code/count arrays.

Replacement for the reference's two KmersMap implementations (ref:
sequences/ShortArrayDNAKmersMapImpl.java — flat short[4^k] for k<=15;
DefaultKmersMapImpl.java — hashmap).  Layout: parallel sorted arrays (codes
int64, counts int32), a CSR-style structure that is
  * mergeable: per-batch sorted runs merge with one sort,
  * queryable: searchsorted + gather, no pointer chasing,
  * saturating at 32767 like the reference (ShortArrayDNAKmersMapImpl.java:61-68).

Per-batch runs counted on a device (kernels/kmers.count_batch_kmers) stay
there as torch tensors (`merge_batch_device`) and are merged ON THAT DEVICE,
all at once, at the first host access: one concatenation, one sort and one
run-length sum, then a single fetch of the distinct codes and counts.  Same
arrays, distribution and files as ngsepcore_tpu/index/kmers_map.py.
"""
from __future__ import annotations

import numpy as np
import torch

SATURATION = 32767


def _merge_runs(codes: torch.Tensor, counts: torch.Tensor):
    """Sum the counts of equal codes: (sorted distinct int64 codes, int32
    counts saturated at SATURATION).  Counts are nonnegative, so saturating
    once equals saturating after every pairwise merge."""
    order = torch.argsort(codes)
    uniq, inverse = torch.unique_consecutive(codes[order], return_inverse=True)
    total = torch.zeros(uniq.shape[0], dtype=torch.int64, device=codes.device)
    total.index_add_(0, inverse, counts[order].to(torch.int64))
    return uniq, torch.clamp(total, max=SATURATION).to(torch.int32)


class KmersMap:
    # pending device entries above which the runs are merged early, so that
    # a long stream of batches holds a bounded amount of device memory
    COMPACT_AT = 1 << 26

    def __init__(self, k: int):
        self.k = k
        self._codes = np.empty(0, dtype=np.int64)
        self._counts = np.empty(0, dtype=np.int32)
        self._pending: list = []  # [(codes int64, counts int32)] device runs
        self._n_pending = 0

    # ---- lazy device-resident batches --------------------------------
    @property
    def codes(self) -> np.ndarray:
        self._materialize()
        return self._codes

    @codes.setter
    def codes(self, v) -> None:
        self._codes = v

    @property
    def counts(self) -> np.ndarray:
        self._materialize()
        return self._counts

    @counts.setter
    def counts(self, v) -> None:
        self._counts = v

    def merge_batch_device(self, uniq_dev: torch.Tensor, counts_dev: torch.Tensor) -> None:
        """Record a device-resident (distinct codes, counts) run; the merge
        and the host fetch wait until a host accessor needs the arrays."""
        if uniq_dev.numel():
            self._pending.append((uniq_dev.to(torch.int64), counts_dev.to(torch.int32)))
            self._n_pending += uniq_dev.numel()
            if self._n_pending > self.COMPACT_AT and len(self._pending) > 1:
                self._pending = [self._merged_pending()]
                self._n_pending = self._pending[0][0].numel()

    def _merged_pending(self):
        return _merge_runs(
            torch.cat([u for u, _ in self._pending]),
            torch.cat([c for _, c in self._pending]),
        )

    def _materialize(self) -> None:
        if not self._pending:
            return
        dev = self._pending[0][0].device
        if len(self._codes):
            self._pending.append(
                (torch.from_numpy(self._codes).to(dev),
                 torch.from_numpy(self._counts).to(dev))
            )
        uniq, counts = self._merged_pending()
        self._pending, self._n_pending = [], 0
        self._codes = uniq.cpu().numpy()
        self._counts = counts.cpu().numpy()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.codes)

    @property
    def size(self) -> int:
        return len(self)

    def merge_batch(self, codes: np.ndarray, counts: np.ndarray) -> None:
        """Merge a sorted (codes, counts) host run into the map."""
        if len(codes) == 0:
            return
        self._materialize()
        uniq, merged = _merge_runs(
            torch.from_numpy(np.concatenate([self._codes, np.asarray(codes, np.int64)])),
            torch.from_numpy(np.concatenate([self._counts, np.asarray(counts, np.int32)])),
        )
        self._codes = uniq.numpy()
        self._counts = merged.numpy()

    def get_count(self, code_or_kmer) -> int:
        if isinstance(code_or_kmer, str):
            from ..kernels.kmers import encode_kmer

            code_or_kmer = encode_kmer(code_or_kmer)
        codes = self.codes
        i = np.searchsorted(codes, code_or_kmer)
        if i < len(codes) and codes[i] == code_or_kmer:
            return int(self.counts[i])
        return 0

    def lookup(self, query_codes: np.ndarray) -> np.ndarray:
        """Vectorized count lookup for an array of codes (0 if absent)."""
        codes = self.codes
        if len(codes) == 0:
            return np.zeros(len(query_codes), dtype=np.int32)
        idx = np.searchsorted(codes, query_codes)
        idx = np.clip(idx, 0, len(codes) - 1)
        hit = codes[idx] == query_codes
        return np.where(hit, self.counts[idx], 0).astype(np.int32)

    def filter_min_count(self, min_count: int) -> None:
        keep = self.counts >= min_count
        self._codes = self._codes[keep]
        self._counts = self._counts[keep]

    def count_distribution(self, max_count: int = 200) -> np.ndarray:
        """Histogram: dist[c] = number of distinct kmers with count c,
        counts clipped at max_count (ref: KmersExtractor distribution
        output, KmersMap.calculateAbundancesDistribution)."""
        clipped = np.minimum(self.counts, max_count)
        return np.bincount(clipped, minlength=max_count + 1)

    def save(self, path: str) -> None:
        np.savez_compressed(path, k=self.k, codes=self.codes, counts=self.counts)

    @classmethod
    def load(cls, path: str) -> "KmersMap":
        data = np.load(path)
        m = cls(int(data["k"]))
        m.codes = data["codes"]
        m.counts = data["counts"]
        return m

    def save_text(self, fh, min_count: int = 1) -> None:
        """kmer<TAB>count text output like the reference's KmersExtractor."""
        from ..kernels.kmers import decode_kmer

        for code, cnt in zip(self.codes, self.counts):
            if cnt >= min_count:
                fh.write(f"{decode_kmer(int(code), self.k)}\t{int(cnt)}\n")
