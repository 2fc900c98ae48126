"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) in NumPy, with the counter layout of the step kernel: key =
the step's two seed words, counter = (aircraft index, draw block, 0, 0),
and a uniform in [0, 1) from the top 23 bits of a word (mantissa fill)."""
from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = np.uint64(0xFFFFFFFF)


def philox4x32_10(ctr, key):
    """ctr: four uint32 arrays (broadcastable), key: two ints. Returns the
    four uint32 output words."""
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
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniforms(seed, rows: np.ndarray, blocks) -> np.ndarray:
    """[4 * len(blocks), len(rows)] float32 uniforms of the aircraft
    `rows`: rows 4b..4b+3 come from counter block `blocks[b]`."""
    i = np.asarray(rows, dtype=np.uint32)
    z = np.zeros_like(i)
    out = []
    for blk in blocks:
        out += [bits_to_unit(w) for w in
                philox4x32_10((i, np.full_like(i, blk), z, z), seed)]
    return np.stack(out)


# Random123's known answers for Philox4x32-10 (kat_vectors): counter, key,
# expected output words.
KNOWN_ANSWERS = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)
