"""Histogram + moments accumulator.

Ref: src/ngsep/math/Distribution.java — histogram with configurable bin
range/width plus running count/sum/sum-of-squares, printed as text
histograms throughout the reference's commands.
"""
from __future__ import annotations

import math

import numpy as np


class Distribution:
    def __init__(self, min_value: float, max_value: float, bin_length: float):
        self.min_value = min_value
        self.max_value = max_value
        self.bin_length = bin_length
        nbins = int((max_value - min_value) / bin_length) + 1
        self.counts = np.zeros(nbins, dtype=np.float64)
        self.outliers_less = 0.0
        self.outliers_more = 0.0
        self.count = 0.0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.max_value_data = -math.inf
        self.min_value_data = math.inf

    def process_datapoint(self, value: float, weight: float = 1.0) -> None:
        self.count += weight
        self.sum += value * weight
        self.sum_sq += value * value * weight
        self.max_value_data = max(self.max_value_data, value)
        self.min_value_data = min(self.min_value_data, value)
        if value < self.min_value:
            self.outliers_less += weight
        elif value > self.max_value:
            self.outliers_more += weight
        else:
            bin_idx = int((value - self.min_value) / self.bin_length)
            self.counts[bin_idx] += weight

    def process_array(self, values: np.ndarray, weights: np.ndarray | None = None) -> None:
        values = np.asarray(values, dtype=np.float64)
        w = np.ones_like(values) if weights is None else np.asarray(weights, np.float64)
        self.count += float(w.sum())
        self.sum += float((values * w).sum())
        self.sum_sq += float((values * values * w).sum())
        if len(values):
            self.max_value_data = max(self.max_value_data, float(values.max()))
            self.min_value_data = min(self.min_value_data, float(values.min()))
        below = values < self.min_value
        above = values > self.max_value
        self.outliers_less += float(w[below].sum())
        self.outliers_more += float(w[above].sum())
        ok = ~(below | above)
        idx = ((values[ok] - self.min_value) / self.bin_length).astype(np.int64)
        np.add.at(self.counts, idx, w[ok])

    @property
    def average(self) -> float:
        return self.sum / self.count if self.count > 0 else 0.0

    @property
    def variance(self) -> float:
        if self.count < 2:
            return 0.0
        return (self.sum_sq - self.sum * self.sum / self.count) / (self.count - 1)

    @property
    def std_dev(self) -> float:
        return math.sqrt(max(0.0, self.variance))

    def local_mode(self, lo: float, hi: float) -> float:
        """Value of the highest bin within [lo, hi] (ref: Distribution.getLocalMode)."""
        i0 = max(0, int((lo - self.min_value) / self.bin_length))
        i1 = min(len(self.counts) - 1, int((hi - self.min_value) / self.bin_length))
        if i1 < i0:
            return lo
        rel = int(np.argmax(self.counts[i0 : i1 + 1]))
        return self.min_value + (i0 + rel) * self.bin_length

    def print_distribution(self, fh) -> None:
        v = self.min_value
        for c in self.counts:
            fh.write(f"{v:g}\t{c:g}\n")
            v += self.bin_length
        if self.outliers_more > 0:
            fh.write(f"More\t{self.outliers_more:g}\n")
