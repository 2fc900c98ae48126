"""Philox4x32-10 in numpy: the plain version of `csrc/philox.cuh`.

The step kernel draws its reset uniforms and sensor noise from Philox keyed
by two seed words, counter (aircraft index, draw block, 0, 0). This module
reproduces those bits on the host, so a check can rebuild the kernel's draws
exactly from the seed it was given.
"""
from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(ctr, key):
    """ctr: four uint32 arrays (broadcastable), key: two uint32 ints.
    Returns the four uint32 output words."""
    x = [np.asarray(c, dtype=np.uint64) for c in ctr]
    k0, k1 = int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF
    for _ in range(10):
        p0 = _M0 * x[0]
        p1 = _M1 * x[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        x = [hi1 ^ x[1] ^ np.uint64(k0), lo1, hi0 ^ x[3] ^ np.uint64(k1), lo0]
        k0 = (k0 + _W0) & 0xFFFFFFFF
        k1 = (k1 + _W1) & 0xFFFFFFFF
    return [a.astype(np.uint32) for a in x]


def bits_to_unit(bits: np.ndarray) -> np.ndarray:
    """[0, 1) float32 from the top 23 bits (mantissa fill)."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniforms(seed, n: int, blocks) -> np.ndarray:
    """[4 * len(blocks), n] float32 uniforms for aircraft 0..n-1: rows
    4b..4b+3 come from counter block `blocks[b]`, as the kernel draws them."""
    i = np.arange(n, dtype=np.uint32)
    z = np.zeros(n, dtype=np.uint32)
    rows = []
    for blk in blocks:
        rows += [bits_to_unit(w) for w in
                 philox4x32_10((i, np.full(n, blk, np.uint32), z, z), seed)]
    return np.stack(rows)
