"""Host-side threefry2x32: the scalars ``jax.random`` draws, without JAX.

The JAX package seeds k-means++ from ``jax.random`` (``PRNGKey``, ``split``,
``uniform`` and ``randint`` of shape ``()``). This module computes the same
32-bit words on the host, so the port picks the same seed rows without
importing JAX. It follows JAX's default generator (``threefry2x32``) with
``jax_threefry_partitionable = True``, the default of the JAX releases the
reference runs on (0.5 and later): ``split`` and ``random_bits`` hash a
64-bit counter (high word 0, low word the position) under the key, and 32
random bits are the XOR of the two output words. With the flag off JAX lays
the counters out differently and these functions would not match it.

A key is a pair of 32-bit words. Every function takes the words as Python
ints (one key) or as ``numpy.uint64`` arrays of one shape (a batch of keys,
drawn together); sums are masked to 32 bits, so both wrap as uint32 does.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK = 0xFFFFFFFF


def threefry2x32(key, hi, lo):
    """The Threefry-2x32 block function (20 rounds) of the counter
    (``hi``, ``lo``) under ``key`` -> the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (hi + ks[0]) & _MASK
    x1 = (lo + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (x64 off): the high
    word is 0 and the low word the seed's low 32 bits."""
    return 0, int(seed) & _MASK


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: key ``i`` is the block of counter
    (0, i)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key):
    """``jax.random.bits(key, (), uint32)``: the two words of block (0, 0),
    XORed."""
    b0, b1 = threefry2x32(key, 0, 0)
    return b0 ^ b1


def uniform(key):
    """``jax.random.uniform(key, (), float32)`` in [0, 1): 23 random mantissa
    bits under the exponent of 1.0, less 1.0."""
    bits = np.asarray((random_bits(key) >> 9) | 0x3F800000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key, maxval: int):
    """``jax.random.randint(key, (), 0, maxval)`` for 0 < maxval < 2**31:
    64 random bits from two sub-keys, reduced modulo the span in uint32
    arithmetic as JAX does (biased where the span is no power of two; the
    multiplier's square wraps to 0 for spans above 2**16; equal to JAX's
    bits in both)."""
    if not 0 < maxval < 2**31:
        raise ValueError(f"randint needs 0 < maxval < 2**31, got {maxval}")
    k1, k2 = split(key)
    higher, lower = random_bits(k1), random_bits(k2)
    multiplier = ((2**16 % maxval) ** 2 & _MASK) % maxval
    offset = (((higher % maxval) * multiplier) & _MASK) + lower % maxval
    return (offset & _MASK) % maxval


def kmeans_pp_scalars(seed: int, m: int, k: int):
    """Every random scalar k-means++ needs for ``k`` seeds over ``m`` sample
    rows, as the JAX package draws them: ``PRNGKey(seed)`` is split in 3 and
    its second key seeds the init; that key is split in 2 for ``first``;
    then step ``i`` (1 <= i < k) splits the running key in 3 for its
    threshold ``u[i]`` and its fallback row ``uniform_idx[i]``. The chain of
    running keys is walked key by key; the k - 1 thresholds and rows are
    then drawn as one batch.
    -> (first, u [k] float32, uniform_idx [k] int64); slot 0 of the arrays is
    unused."""
    _, key, _ = split(prng_key(seed), 3)
    key, sub = split(key)
    first = int(randint(sub, m))
    u = np.zeros(k, np.float32)
    uniform_idx = np.zeros(k, np.int64)
    if k > 1:
        t_keys = np.empty((2, k - 1), np.uint64)
        u_keys = np.empty((2, k - 1), np.uint64)
        for i in range(k - 1):
            key, t_keys[:, i], u_keys[:, i] = split(key, 3)
        u[1:] = uniform(tuple(t_keys))
        uniform_idx[1:] = randint(tuple(u_keys), m)
    return first, u, uniform_idx
