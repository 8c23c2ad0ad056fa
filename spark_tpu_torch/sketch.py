"""Probabilistic sketches: the host HyperLogLog (the part of
``spark_tpu/sketch.py`` the hybrid hash join calls; the device
count-min and Bloom sketches come with ROADMAP A10).

Numpy only: the hybrid join folds each chunk's join keys into the
registers on the host while it partitions them.
"""

from __future__ import annotations

import math

import numpy as np


def hll_estimate(registers: np.ndarray) -> float:
    """HyperLogLog distinct estimate from register maxima: the harmonic
    mean alpha_m * m^2 / sum(2^-M_j), with linear counting
    (m * ln(m / V), V zero registers) in the small range where raw HLL
    biases high (Flajolet et al. 2007; the corrections the reference's
    HyperLogLogPlusPlusHelper applies)."""
    m = int(registers.size)
    if m == 0:
        return 0.0
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / float(
        np.sum(np.power(2.0, -registers.astype(np.float64))))
    zeros = int((registers == 0).sum())
    if est <= 2.5 * m and zeros:
        est = m * math.log(m / zeros)
    return float(est)


class HyperLogLog:
    """Host HLL over int64 columns with ``registers`` (a power of two)
    registers: the register index is the hash's low p bits, the rank the
    leading-zero count of the remaining 64 - p bits. Merging is an
    elementwise max."""

    _MIX = np.uint64(0x9E3779B97F4A7C15)

    def __init__(self, registers: int = 256):
        if registers < 2 or registers & (registers - 1):
            raise ValueError(f"registers must be a power of two: {registers}")
        self.m = int(registers)
        self.p = self.m.bit_length() - 1
        self.registers = np.zeros(self.m, dtype=np.int64)

    def update(self, vals: np.ndarray) -> None:
        """Fold one chunk of int64 values into the registers."""
        h = np.asarray(vals).astype(np.uint64) * self._MIX
        idx = (h & np.uint64(self.m - 1)).astype(np.int64)
        rest = (h >> np.uint64(self.p)).astype(np.float64)
        nbits = 64 - self.p
        msb = np.floor(np.log2(np.maximum(rest, 1.0)))
        rank = np.where(rest > 0, nbits - msb, nbits + 1).astype(np.int64)
        np.maximum.at(self.registers, idx, rank)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if self.m != other.m:
            raise ValueError("register counts differ")
        out = HyperLogLog(self.m)
        out.registers = np.maximum(self.registers, other.registers)
        return out

    def estimate(self) -> float:
        return hll_estimate(self.registers)
