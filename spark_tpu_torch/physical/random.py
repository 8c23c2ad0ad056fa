"""The sampler's random stream: JAX's counter-based ``threefry2x32``,
bit for bit, in int64 torch ops.

``SampleExec`` keeps row i when draw i is below the fraction. The
reference draws ``jax.random.uniform(jax.random.PRNGKey(seed),
(capacity,))`` in float64 (the engine runs JAX with x64 on), with JAX's
default ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on. This module computes the same draws: the key is the seed's high and
low 32-bit words; draw i hashes the counter pair (i >> 32, i & 0xffffffff)
with Threefry-2x32 (20 rounds, five key injections) into two words
(hi, lo); the 64 bits hi << 32 | lo become a float64 by uniform's
mantissa trick, ``(bits >> 12) | bits(1.0)`` read as a double, minus 1.

Every 32-bit word is held in an int64 and masked after each add and
shift, so the ops are exact integer ops: the same draws on the CPU and on
the card (``torch.Generator`` streams differ between the two).
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000  # float64 1.0
_MANTISSA = (1 << 52) - 1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of counter words ``x0``, ``x1`` (int64 tensors of
    32-bit values) under key (``k0``, ``k1``): two int64 tensors of
    32-bit words, as ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k0 & _MASK32, k1 & _MASK32, (k0 ^ k1 ^ _PARITY) & _MASK32)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32-bit
    words."""
    seed &= (1 << 64) - 1
    return seed >> 32, seed & _MASK32


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: Threefry-2x32 of the counter
    pair (0, data as uint32) under ``key``, as JAX's
    ``threefry_2x32(key, threefry_seed(uint32(data)))``. Host ints in,
    the new key's two words out (the mesh folds each rank in)."""
    return threefry2x32(key[0], key[1], 0, data & _MASK32)


def random_bits64(seed: int, n: int, device, key=None) -> torch.Tensor:
    """``jax.random.bits(PRNGKey(seed), (n,), uint64)`` (or of ``key``, a
    pair of 32-bit words, where given) as int64 (the same 64 bits, read
    signed)."""
    k0, k1 = prng_key(seed) if key is None else key
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(k0, k1, i >> 32, i & _MASK32)
    return (hi << 32) | lo


def uniform(seed: int, n: int, device, key=None) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), (n,), float64)`` (or of
    ``key``, where given): n draws in [0, 1)."""
    bits = random_bits64(seed, n, device, key)
    # a logical shift right by 12: the arithmetic shift, masked
    mantissa = (bits >> 12) & _MANTISSA
    return (mantissa | _ONE_BITS).view(torch.float64) - 1.0
