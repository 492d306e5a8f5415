"""Plain reference of kernel K2's search: for each query descriptor, the
nearest and second-nearest of the valid candidates by Hamming distance.

The semantics as the port states them (``tpuslam_torch/kernels/match.py``,
frozen here): 256-bit descriptors held as eight 32-bit words; an invalid
candidate costs 1e9; the first minimum wins a tie, and a tied minimum
surfaces as the second distance equal to the first.  Integer arithmetic in
NumPy, so a sound kernel agrees exactly.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

BIG = 1e9
_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_top2(desc_a, desc_b, valid_b, block: int = 128):
    """(N, 8), (M, 8) 32-bit words, (M,) bool -> (idx (N,) int64, d1 (N,)
    float64, d2 (N,) float64)."""
    a = np.ascontiguousarray(desc_a).view(np.uint32).reshape(len(desc_a), 8)
    b = np.ascontiguousarray(desc_b).view(np.uint32).reshape(len(desc_b), 8)
    valid = np.asarray(valid_b, bool)
    idx = np.zeros(len(a), np.int64)
    d1 = np.zeros(len(a), np.float64)
    d2 = np.zeros(len(a), np.float64)
    for r in range(0, len(a), block):
        x = (a[r:r + block, None, :] ^ b[None, :, :]).view(np.uint8)  # (n, M, 32) bytes
        dist = _POPCOUNT8[x].sum(axis=-1).astype(np.float64)
        dist[:, ~valid] = BIG
        i = np.argmin(dist, axis=1)
        rows = np.arange(len(i))
        idx[r:r + block], d1[r:r + block] = i, dist[rows, i]
        dist[rows, i] = BIG
        d2[r:r + block] = dist.min(axis=1)
    return idx, d1, d2


def mismatched_rows(sample) -> int:
    """Rows of one recorded call (``desc_a``, ``desc_b``, ``valid_b``,
    ``idx``, ``d1``, ``d2`` as host arrays) whose index or either distance
    differs from the plain search."""
    idx, d1, d2 = hamming_top2(sample["desc_a"], sample["desc_b"], sample["valid_b"])
    return int(np.sum((np.asarray(sample["idx"], np.int64) != idx)
                      | (np.asarray(sample["d1"], np.float64) != d1)
                      | (np.asarray(sample["d2"], np.float64) != d2)))
