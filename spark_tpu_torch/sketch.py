"""Probabilistic sketches (the port of ``spark_tpu/sketch.py``; reference:
common/sketch/src/main/java/org/apache/spark/util/sketch/
CountMinSketch.java:54, BloomFilter.java:42).

- ``hll_estimate`` and ``HyperLogLog``: the distinct-count estimator and
  the host HyperLogLog (numpy), which the hybrid hash join folds each
  chunk's join keys into and whose registers the mesh's exchange stats
  stage (``parallel/operators.ExchangeStatsExec``) produces on the device
  in the same shape.
- ``CountMinSketch`` and ``BloomFilter``: dense tensors on a device,
  updated with vectorized hashing over whole columns (the reference
  updates row by row in JVM loops). Merging is an elementwise add or
  OR, so sketches built per rank combine with a psum or an any.

Every hash is ``physical/kernels.hash64`` of the value XOR a seed, the
reference's, so tables and bits equal the reference's on the same keys.
torch has no uint64 arithmetic: the hashes are int64 holding the uint64
bits, and ``_umod`` takes the unsigned remainder.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from spark_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from spark_tpu_torch.physical import kernels as K


def _seeds(seed: int, n: int) -> list:
    """The reference's hash seeds: ``n`` draws in [1, 2^62) of numpy's
    default generator (all below 2^63, so they are int64 as they are)."""
    return [int(s) for s in
            np.random.default_rng(seed).integers(1, 1 << 62, n)]


def _umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h mod m`` of the uint64 whose bits int64 ``h`` holds."""
    r = torch.remainder(h, m)
    return torch.where(h < 0, torch.remainder(r + (1 << 64) % m, m), r)


def _column_hashes(values: torch.Tensor, seeds) -> torch.Tensor:
    """(len(seeds), n) hashes of an int64 column, one row per seed."""
    x = values.to(torch.int64)
    return torch.stack([K.hash64(x ^ int(s)) for s in seeds])


def _as_tensor(values, device) -> torch.Tensor:
    if torch.is_tensor(values):
        return values.to(device)
    return torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)


def hll_estimate(registers: np.ndarray) -> float:
    """HyperLogLog distinct estimate from register maxima: the harmonic
    mean alpha_m * m^2 / sum(2^-M_j), with linear counting
    (m * ln(m / V), V zero registers) in the small range where raw HLL
    biases high (Flajolet et al. 2007; the corrections the reference's
    HyperLogLogPlusPlusHelper applies). The one estimator every HLL of
    the port shares: the exchange stats stage's group-key registers, the
    hybrid join's host oracle and ``HyperLogLog`` below."""
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
    leading-zero count of the remaining 64 - p bits (through a float
    log2, as the reference: a rank one off near powers of two is noise
    for a sketch). Merging is an elementwise max."""

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


class CountMinSketch:
    """Conservative frequency estimation: a (depth, width) int64 table on
    ``device``; an estimate is the min over the rows (never an
    under-count). ``add`` returns a new sketch, as the reference's."""

    def __init__(self, depth: int = 5, width: int = 2048,
                 table: Optional[torch.Tensor] = None, seed: int = 42,
                 device=DEFAULT_DEVICE):
        self.depth = int(depth)
        self.width = int(width)
        self.seed = seed
        self.seeds = _seeds(seed, self.depth)
        self.device = table.device if table is not None \
            else resolve_device(device)
        self.table = (torch.zeros((self.depth, self.width), dtype=torch.int64,
                                  device=self.device)
                      if table is None else table)

    @classmethod
    def for_rsd(cls, eps: float = 0.01, confidence: float = 0.99,
                seed: int = 42, device=DEFAULT_DEVICE) -> "CountMinSketch":
        """Sized from error bounds (reference: CountMinSketch.create)."""
        width = int(math.ceil(2.0 / eps))
        depth = int(math.ceil(-math.log(1 - confidence) / math.log(2)))
        return cls(depth, width, seed=seed, device=device)

    def _slots(self, values: torch.Tensor) -> torch.Tensor:
        return _umod(_column_hashes(values, self.seeds), self.width)

    def add(self, values, mask=None) -> "CountMinSketch":
        x = _as_tensor(values, self.device)
        idx = self._slots(x)
        ones = (torch.ones(x.shape[0], dtype=torch.int64, device=self.device)
                if mask is None
                else _as_tensor(mask, self.device).to(torch.int64))
        table = self.table.clone()
        for d in range(self.depth):
            table[d].index_add_(0, idx[d], ones)
        return CountMinSketch(self.depth, self.width, table, self.seed)

    def estimate(self, value: int) -> int:
        idx = self._slots(torch.tensor([int(value)], dtype=torch.int64,
                                       device=self.device))[:, 0]
        rows = self.table[torch.arange(self.depth, device=self.device), idx]
        return int(rows.min())

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        if (self.depth, self.width) != (other.depth, other.width):
            raise ValueError("Count-Min shapes differ")
        return CountMinSketch(self.depth, self.width,
                              self.table + other.table.to(self.device),
                              self.seed)


class BloomFilter:
    """Membership filter; mergeable by OR (reference: BloomFilter.java:42
    putLong/mightContainLong). False positives possible, negatives not."""

    def __init__(self, num_bits: int = 1 << 16, num_hashes: int = 5,
                 bits: Optional[torch.Tensor] = None, seed: int = 7,
                 device=DEFAULT_DEVICE):
        self.num_bits = int(num_bits)
        self.num_hashes = int(num_hashes)
        self.seed = seed
        self.seeds = _seeds(seed, self.num_hashes)
        self.device = bits.device if bits is not None \
            else resolve_device(device)
        self.bits = (torch.zeros((self.num_bits,), dtype=torch.bool,
                                 device=self.device)
                     if bits is None else bits)

    @classmethod
    def for_items(cls, expected: int, fpp: float = 0.03, seed: int = 7,
                  device=DEFAULT_DEVICE) -> "BloomFilter":
        n_bits = int(-expected * math.log(fpp) / (math.log(2) ** 2))
        n_bits = max(64, 1 << (n_bits - 1).bit_length())  # power of two
        k = max(1, round(n_bits / expected * math.log(2)))
        return cls(n_bits, k, seed=seed, device=device)

    def _slots(self, values: torch.Tensor) -> torch.Tensor:
        return _umod(_column_hashes(values, self.seeds), self.num_bits)

    def add(self, values, mask=None) -> "BloomFilter":
        x = _as_tensor(values, self.device)
        idx = self._slots(x)
        on = (torch.ones(x.shape[0], dtype=torch.uint8, device=self.device)
              if mask is None
              else _as_tensor(mask, self.device).to(torch.uint8))
        bits = self.bits.to(torch.uint8)
        for d in range(self.num_hashes):
            bits = bits.scatter_reduce(0, idx[d], on, "amax")
        return BloomFilter(self.num_bits, self.num_hashes, bits.bool(),
                           self.seed)

    def might_contain(self, values) -> torch.Tensor:
        """Membership of a whole column (the runtime join filter's shape,
        reference: InjectRuntimeFilter)."""
        x = _as_tensor(values, self.device)
        idx = self._slots(x)
        out = torch.ones(x.shape[0], dtype=torch.bool, device=self.device)
        for d in range(self.num_hashes):
            out = out & self.bits[idx[d]]
        return out

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        if (self.num_bits, self.num_hashes) != (other.num_bits,
                                                other.num_hashes):
            raise ValueError("Bloom filter shapes differ")
        return BloomFilter(self.num_bits, self.num_hashes,
                           self.bits | other.bits.to(self.device), self.seed)
