"""Hash-aggregate kernels for a vector machine.

The reference runs DataFusion's repartitioned hash aggregate
(config/mod.rs:31). On the device a hash table of scalar probes is the
wrong shape; instead:

  * **Dictionary path** (group keys already int codes — chrom, feature type):
    a single ``segment_sum`` over codes. One pass over device memory.
  * **Generic path**: sort rows by packed 64-bit key, then segment-reduce on
    key-change boundaries. One XLA sort replaces the hash table; this is
    the data-parallel "hash" aggregate.

Both paths mask padding rows and return fixed-capacity group arrays plus a
dynamic group count.
"""

from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp

AggFn = Literal["count", "sum", "min", "max"]

_INT_MIN = jnp.iinfo(jnp.int64).min
_INT_MAX = jnp.iinfo(jnp.int64).max


def grouped_reduce_codes(codes: jnp.ndarray, mask: jnp.ndarray,
                         values: jnp.ndarray | None, fn: AggFn,
                         num_groups: int) -> jnp.ndarray:
    """Aggregate ``values`` per group code in [0, num_groups). O(n) scatter-add."""
    codes = jnp.clip(codes.astype(jnp.int32), 0, num_groups - 1)
    if fn == "count":
        contrib = mask.astype(jnp.int64)
        return jnp.zeros(num_groups, jnp.int64).at[codes].add(contrib)
    assert values is not None
    if fn == "sum":
        contrib = jnp.where(mask, values, 0)
        return jnp.zeros(num_groups, values.dtype).at[codes].add(contrib)
    if fn == "min":
        fill = _dtype_max(values.dtype)
        contrib = jnp.where(mask, values, fill)
        return jnp.full(num_groups, fill, values.dtype).at[codes].min(contrib)
    if fn == "max":
        fill = _dtype_min(values.dtype)
        contrib = jnp.where(mask, values, fill)
        return jnp.full(num_groups, fill, values.dtype).at[codes].max(contrib)
    raise ValueError(fn)


def _dtype_max(dt):
    return jnp.asarray(jnp.inf if jnp.issubdtype(dt, jnp.floating)
                       else jnp.iinfo(dt).max, dt)


def _dtype_min(dt):
    return jnp.asarray(-jnp.inf if jnp.issubdtype(dt, jnp.floating)
                       else jnp.iinfo(dt).min, dt)


def ungrouped_reduce(values: jnp.ndarray, mask: jnp.ndarray, fn: AggFn):
    if fn == "count":
        return jnp.sum(mask, dtype=jnp.int64)
    if fn == "sum":
        return jnp.sum(jnp.where(mask, values, 0))
    if fn == "min":
        return jnp.min(jnp.where(mask, values, _dtype_max(values.dtype)))
    if fn == "max":
        return jnp.max(jnp.where(mask, values, _dtype_min(values.dtype)))
    raise ValueError(fn)


# ---------------------------------------------------------------------------
# Generic (sort-based) group-by over arbitrary int64 keys
# ---------------------------------------------------------------------------


def sort_group_ids(keys: jnp.ndarray, mask: jnp.ndarray
                   ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assign dense group ids to arbitrary int64 keys.

    Returns (group_ids int32[cap] aligned to *input* rows, group_keys
    int64[cap] (first occurrence order = sorted order), num_groups).
    Padding rows get group id = cap-1 sentinel and must stay masked.
    """
    cap = keys.shape[0]
    big = jnp.asarray(_INT_MAX, jnp.int64)
    k = jnp.where(mask, keys.astype(jnp.int64), big)
    perm = jnp.argsort(k, stable=True)
    ks = k[perm]
    newgrp = jnp.concatenate([jnp.ones(1, jnp.int32),
                              (ks[1:] != ks[:-1]).astype(jnp.int32)])
    newgrp = jnp.where(ks == big, 0, newgrp)
    gid_sorted = jnp.cumsum(newgrp, dtype=jnp.int32) - 1
    num_groups = gid_sorted[-1] + 1 if cap else jnp.int32(0)
    num_groups = jnp.maximum(num_groups, 0)
    # scatter back to input order
    gids = jnp.zeros(cap, jnp.int32).at[perm].set(jnp.clip(gid_sorted, 0, cap - 1))
    # group_keys[g] = key of group g
    group_keys = jnp.full(cap, big, jnp.int64).at[jnp.clip(gid_sorted, 0, cap - 1)].min(ks)
    return gids, group_keys, num_groups


def pack_keys(cols: list[jnp.ndarray], bits: list[int]) -> jnp.ndarray:
    """Pack multiple small-int key columns into one int64 radix key."""
    assert sum(bits) <= 63, "packed key exceeds 63 bits"
    out = jnp.zeros(cols[0].shape[0], jnp.int64)
    for c, b in zip(cols, bits):
        out = (out << b) | (c.astype(jnp.int64) & ((1 << b) - 1))
    return out
