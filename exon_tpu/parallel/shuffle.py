"""Distributed hash-partition shuffle + shuffled aggregation.

The distributed substrate of the engine (BASELINE.json north star): tables
hash-partitioned by key (chromosome / position-bucket), exchanged with
``lax.all_to_all`` inside ``shard_map``, which XLA hands to the device
collectives.

Design notes:
  * Static shapes: each device sends a fixed-capacity bucket to every peer
    (``bucket_cap``); real counts travel alongside, receivers mask padding.
    Overflow is always reported, never silent — callers retry with bigger
    buckets (exchange_and_merge) or fall back (partitioned join).
  * The local reorder before exchange is one stable sort by destination —
    an O(n log n) on-chip XLA sort, bandwidth-bound in practice.
  * Hot-key skew (chr1 ≫ chrM): the engine needs NO salting because every
    exchanged row is already a pre-aggregated group partial — a hot key
    costs one state row per device regardless of its row count, and
    cardinality overflow spills merged partials to host
    (distributed.py DistributedAggregateExec). A salted two-phase
    group count lived here through round 4 as a substrate demo
    (salt spreads a hot key over sub-partitions, partially aggregates,
    then psums); it was never reachable from the engine and was removed
    round 5 — git history ``bacbef8`` has it with its exactness test.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _axis_size(axis_name):
    return jax.lax.axis_size(axis_name)


def partition_ids(keys: jnp.ndarray, n_parts: int) -> jnp.ndarray:
    """Destination partition per row: splittable hash of key."""
    h = keys.astype(jnp.uint32)
    # murmur-style finalizer
    h ^= h >> 16
    h *= jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h *= jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return (h % jnp.uint32(n_parts)).astype(jnp.int32)


def bucketize(dest: jnp.ndarray, mask: jnp.ndarray, cols: list[jnp.ndarray],
              n_parts: int, bucket_cap: int
              ) -> tuple[list[jnp.ndarray], jnp.ndarray]:
    """Scatter rows into per-destination buckets [n_parts, bucket_cap].

    Returns (bucketed columns, counts[n_parts]). Rows overflowing a bucket
    are dropped — counts report the true pre-drop totals so overflow is
    detectable and callers retry with bigger buckets.
    """
    cap = dest.shape[0]
    dest = jnp.where(mask, dest, n_parts)  # padding → overflow bin
    order = jnp.argsort(dest, stable=True)
    dest_s = dest[order]
    counts = jnp.zeros(n_parts + 1, jnp.int32).at[jnp.clip(dest_s, 0, n_parts)].add(1)
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts[:-1], dtype=jnp.int32)])
    pos_in_bucket = jnp.arange(cap, dtype=jnp.int32) - starts[jnp.clip(dest_s, 0, n_parts)]
    ok = jnp.logical_and(dest_s < n_parts, pos_in_bucket < bucket_cap)
    flat_idx = jnp.clip(dest_s, 0, n_parts - 1) * bucket_cap + \
        jnp.clip(pos_in_bucket, 0, bucket_cap - 1)
    out_cols = []
    scatter_idx = jnp.where(ok, flat_idx, n_parts * bucket_cap)  # extra slot
    for c in cols:
        src = c[order]
        buf = jnp.zeros((n_parts * bucket_cap + 1,) + c.shape[1:], c.dtype)
        buf = buf.at[scatter_idx].set(src)
        out_cols.append(buf[:-1].reshape(n_parts, bucket_cap, *c.shape[1:]))
    return out_cols, counts[:n_parts]


def _bshape(mask, arr):
    return mask.reshape(mask.shape + (1,) * (arr.ndim - 1))


def hash_partition_shuffle(axis_name: str, keys: jnp.ndarray,
                           mask: jnp.ndarray, cols: list[jnp.ndarray],
                           bucket_cap: int
                           ) -> tuple[jnp.ndarray, jnp.ndarray,
                                      list[jnp.ndarray], jnp.ndarray]:
    """All-to-all exchange of rows keyed by hash(keys) (inside shard_map).

    Returns (recv_keys [n_dev*bucket_cap], recv_mask, recv_cols, overflow):
    all rows now on the device owning their key partition. ``overflow`` is a
    global bool scalar — True when any sender dropped rows because a bucket
    exceeded ``bucket_cap`` (callers must either size bucket_cap for the
    worst case, pre-aggregate, or retry bigger — never ignore it).
    """
    n_dev = _axis_size(axis_name)
    dest = partition_ids(keys, n_dev)
    bucketed, counts = bucketize(dest, mask, [keys] + cols, n_dev, bucket_cap)
    # exchange bucket i → device i
    recv = [jax.lax.all_to_all(b, axis_name, 0, 0) for b in bucketed]
    # counts: each device needs count sent *to it* by each peer
    sent_counts = jnp.minimum(counts, bucket_cap)  # clipped = actually sent
    recv_counts = jax.lax.all_to_all(sent_counts.reshape(n_dev, 1),
                                     axis_name, 0, 0).reshape(n_dev)
    slot = jnp.arange(bucket_cap, dtype=jnp.int32)
    recv_mask = (slot[None, :] < recv_counts[:, None]).reshape(-1)
    flat = [r.reshape((n_dev * bucket_cap,) + r.shape[2:]) for r in recv]
    dropped = jnp.any(counts > bucket_cap)
    overflow = jax.lax.psum(dropped.astype(jnp.int32), axis_name) > 0
    return flat[0], recv_mask, flat[1:], overflow


def distributed_group_count(axis_name: str, codes: jnp.ndarray,
                            mask: jnp.ndarray, num_groups: int,
                            bucket_cap: int) -> jnp.ndarray:
    """Group-by count across the mesh: shuffle rows to key owners via
    all_to_all, count locally, then all_gather the per-owner partials.

    For pure counts a psum of local partials is cheaper; this routine exists
    to exercise/benchmark the true shuffle path that joins and wide
    aggregations need. Returns the full [num_groups] counts on every device.
    """
    keys, rmask, _, _ = hash_partition_shuffle(
        axis_name, codes.astype(jnp.int64), mask, [], bucket_cap)
    local = jnp.zeros(num_groups, jnp.int64).at[
        jnp.clip(keys, 0, num_groups - 1).astype(jnp.int32)
    ].add(rmask.astype(jnp.int64))
    # each group's rows live on exactly one device → sum-gather is exact
    return jax.lax.psum(local, axis_name)


def distributed_group_sum(axis_name: str, codes: jnp.ndarray,
                          values: jnp.ndarray, mask: jnp.ndarray,
                          num_groups: int, bucket_cap: int) -> jnp.ndarray:
    keys, rmask, (vals,), _ = hash_partition_shuffle(
        axis_name, codes.astype(jnp.int64), mask, [values], bucket_cap)
    local = jnp.zeros(num_groups, values.dtype).at[
        jnp.clip(keys, 0, num_groups - 1).astype(jnp.int32)
    ].add(jnp.where(rmask, vals, 0))
    return jax.lax.psum(local, axis_name)
