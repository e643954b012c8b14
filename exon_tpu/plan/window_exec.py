"""Window functions as fused device sorts and scans.

The reference inherits window functions from DataFusion 44. Here the whole
OVER computation is one fused device kernel per window call:

  sort rows by (liveness, partition-hash, order keys)   — one XLA sort chain
  segment boundaries → partition ids, peer-group ids    — cumsum of flags
  per-function result in sorted order                   — segment reductions
  scatter back to input row order                       — one gather

Frame semantics match DataFusion defaults: aggregates with ORDER BY use
RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW (peer rows share values);
without ORDER BY the frame is the whole partition.

Supported: row_number, rank, dense_rank, ntile, percent_rank, cume_dist,
count, sum, min, max, avg, lag, lead, first_value, last_value; explicit
ROWS frames (cumsum endpoints; sparse-table min/max) and RANGE frames
(per-row binary search on the sorted order key) for the aggregates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import Batch, FixedColumn, Schema
from ..errors import PlanError
from .expressions import WindowCall, eval_expr, _as_values, _validity_of
from .physical import (PhysicalPlan, _group_key_i64, _sort_key_values,
                       concat_batches)

WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "count", "sum", "min",
                "max", "avg", "lag", "lead", "first_value", "last_value",
                "nth_value",
                "ntile", "percent_rank", "cume_dist"}


@dataclasses.dataclass
class WindowExec(PhysicalPlan):
    calls: list[WindowCall]
    names: list[str]
    out_schema: Schema
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        combined = concat_batches(self.input.schema(), list(self.input.batches()))
        if combined.num_rows_host() == 0:
            from .physical import _empty_batch

            yield _empty_batch(self.out_schema)
            return
        step = _jit_window_step(tuple(self.calls), self.out_schema)
        yield step(combined)


@functools.cache
def _jit_window_step(calls: tuple, out_schema: Schema):
    @jax.jit
    def step(batch: Batch) -> Batch:
        cols = list(batch.columns)
        for call in calls:
            vals, valid = _window_column(call, batch)
            cols.append(FixedColumn(vals, valid))
        return Batch(out_schema, cols, batch.length)

    return step


def _window_column(call: WindowCall, batch: Batch):
    cap = batch.capacity
    mask = batch.row_mask()
    idx = jnp.arange(cap, dtype=jnp.int32)

    # ---- sort: liveness (live first) > partition > order keys -------------
    # validity rides as its own key column per order key (nulls ASC last /
    # DESC first without sentinel values, which collide with float bitcasts)
    from .physical import _sort_key_value_raw

    from .expressions import NullsOrder

    perm = idx
    okeys = []
    key_pairs = []
    for e, asc in call.order_by:
        nulls_first = None
        if isinstance(e, NullsOrder):
            nulls_first, e = e.first, e.child
        k, valid = _sort_key_value_raw(eval_expr(e, batch), batch)
        key_pairs.append((k, valid))
        if nulls_first is None:
            vk = jnp.logical_not(valid).astype(jnp.int64)
        else:
            # direct placement: cancel the asc inversion applied below
            vk = (valid if nulls_first
                  else jnp.logical_not(valid)).astype(jnp.int64)
            if not asc:
                vk = jnp.int64(-1) - vk
        okeys.append((vk, asc))
        okeys.append((k, asc))
    for k, asc in reversed(okeys):
        kk = k[perm]
        if not asc:
            kk = jnp.int64(-1) - kk
        perm = perm[jnp.argsort(kk, stable=True)]
    if call.partition_by:
        pkey = _group_key_i64(tuple(call.partition_by), batch)
    else:
        pkey = jnp.zeros(cap, jnp.int64)
    perm = perm[jnp.argsort(pkey[perm], stable=True)]
    perm = perm[jnp.argsort(jnp.logical_not(mask[perm]), stable=True)]

    mask_s = mask[perm]
    pkey_s = pkey[perm]
    first_row = jnp.concatenate([jnp.ones(1, bool), jnp.zeros(cap - 1, bool)])
    seg_new = jnp.logical_or(
        first_row, jnp.concatenate([jnp.ones(1, bool),
                                    pkey_s[1:] != pkey_s[:-1]]))
    seg_new = jnp.logical_or(
        seg_new, jnp.concatenate([jnp.zeros(1, bool),
                                  mask_s[1:] != mask_s[:-1]]))
    seg_id = jnp.cumsum(seg_new.astype(jnp.int32)) - 1
    seg_start = jnp.full(cap, cap, jnp.int32).at[seg_id].min(idx)
    start_of = seg_start[seg_id]

    peer_new = seg_new
    for k, valid in key_pairs:
        ks, vs = k[perm], valid[perm]
        peer_new = jnp.logical_or(
            peer_new, jnp.concatenate([jnp.ones(1, bool), ks[1:] != ks[:-1]]))
        peer_new = jnp.logical_or(
            peer_new, jnp.concatenate([jnp.ones(1, bool), vs[1:] != vs[:-1]]))
    peer_id = jnp.cumsum(peer_new.astype(jnp.int32)) - 1
    peer_first = jnp.full(cap, cap, jnp.int32).at[peer_id].min(idx)
    peer_last = jnp.zeros(cap, jnp.int32).at[peer_id].max(idx)
    pf, pl = peer_first[peer_id], peer_last[peer_id]

    seg_end = jnp.zeros(cap, jnp.int32).at[seg_id].max(idx)
    end_of = seg_end[seg_id]

    fn = call.fn
    n_part = (end_of - start_of + 1).astype(jnp.int64)
    if fn == "row_number":
        res_s = (idx - start_of + 1).astype(jnp.int64)
        valid_s = mask_s
    elif fn == "rank":
        res_s = (pf - start_of + 1).astype(jnp.int64)
        valid_s = mask_s
    elif fn == "dense_rank":
        pn = peer_new.astype(jnp.int64)
        c = jnp.cumsum(pn)
        res_s = c - c[start_of] + 1
        valid_s = mask_s
    elif fn == "percent_rank":
        # (rank - 1) / (rows - 1); 0 for single-row partitions
        rank = (pf - start_of).astype(jnp.float64)
        res_s = jnp.where(n_part > 1,
                          rank / jnp.maximum(n_part - 1, 1).astype(jnp.float64),
                          0.0)
        valid_s = mask_s
    elif fn == "cume_dist":
        res_s = (pl - start_of + 1).astype(jnp.float64) / \
            jnp.maximum(n_part, 1).astype(jnp.float64)
        valid_s = mask_s
    elif fn == "ntile":
        k = jnp.int64(max(int(call.offset), 1))
        r = (idx - start_of).astype(jnp.int64)
        kk = jnp.minimum(k, jnp.maximum(n_part, 1))
        base = n_part // kk          # small bucket size
        rem = n_part % kk            # first `rem` buckets get base + 1
        cut = rem * (base + 1)       # rows covered by the big buckets
        res_s = jnp.where(
            r < cut,
            r // jnp.maximum(base + 1, 1),
            rem + (r - cut) // jnp.maximum(base, 1)) + 1
        valid_s = mask_s
    elif fn in ("count", "sum", "min", "max", "avg") or (
            fn in ("first_value", "last_value", "nth_value")
            and getattr(call, "frame", None) is not None):
        range_info = None
        frame = getattr(call, "frame", None)
        if frame is not None and frame[0] == "range":
            # RANGE offsets are value offsets on the (single) ORDER BY key
            if len(call.order_by) != 1:
                raise PlanError("RANGE frame offsets require exactly one "
                                "ORDER BY key")
            e0, asc0 = call.order_by[0]
            if isinstance(e0, NullsOrder):
                e0 = e0.child
            v0 = eval_expr(e0, batch)
            if not isinstance(v0, (jnp.ndarray, np.ndarray)) and \
                    not hasattr(v0, "values"):
                raise PlanError("RANGE frame ORDER BY key must be numeric")
            nums = _as_values(v0, batch)
            if not (jnp.issubdtype(nums.dtype, jnp.integer)
                    or jnp.issubdtype(nums.dtype, jnp.floating)):
                raise PlanError("RANGE frame ORDER BY key must be numeric")
            vnum_s = nums[perm]
            if not asc0:
                vnum_s = -vnum_s  # normalize to ascending
            kvalid_s = jnp.logical_and(_validity_of(v0, batch)[perm],
                                       mask_s)
            range_info = (vnum_s, kvalid_s)
        res_s, valid_s = _window_aggregate(call, batch, perm, mask_s,
                                           seg_id, start_of, pl, idx,
                                           end_of, range_info=range_info)
    elif fn in ("lag", "lead"):
        res_s, valid_s = _window_shift(call, batch, perm, mask_s,
                                       start_of, end_of, idx)
    elif fn in ("first_value", "last_value", "nth_value"):
        v = eval_expr(call.child, batch)
        vals_s = _as_values(v, batch)[perm]
        vv_s = jnp.logical_and(_validity_of(v, batch)[perm], mask_s)
        if fn == "nth_value":
            # default frame runs to the current peer group's end
            raw = start_of + call.offset - 1
            src = jnp.clip(raw, 0, cap - 1)
            res_s = vals_s[src]
            valid_s = jnp.logical_and(
                jnp.logical_and(vv_s[src], mask_s), raw <= pl)
        else:
            src = start_of if fn == "first_value" else pl
            res_s = vals_s[src]
            valid_s = jnp.logical_and(vv_s[src], mask_s)
    else:
        raise PlanError(f"window function {fn!r} unsupported")

    out = jnp.zeros(cap, res_s.dtype).at[perm].set(res_s)
    out_valid = jnp.zeros(cap, bool).at[perm].set(valid_s)
    return out, jnp.logical_and(out_valid, mask)


def _bsearch(vals, lo0, hi0, target, strict: bool):
    """Vectorized per-row binary search over sorted ``vals``.

    Returns the smallest j in [lo0, hi0+1) with vals[j] >= target
    (strict=False) or vals[j] > target (strict=True); hi0+1 if none.
    All arguments are per-row arrays; iteration count is static."""
    n = vals.shape[0]
    lo = lo0.astype(jnp.int64)
    hi = (hi0 + 1).astype(jnp.int64)
    for _ in range(max(n, 2).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        vm = vals[jnp.clip(mid, 0, n - 1)]
        right = vm <= target if strict else vm < target
        lo = jnp.where(jnp.logical_and(active, right), mid + 1, lo)
        hi = jnp.where(jnp.logical_and(active, jnp.logical_not(right)),
                       mid, hi)
    return lo


def _window_aggregate(call: WindowCall, batch: Batch, perm, mask_s,
                      seg_id, start_of, peer_last_of, idx, end_of=None,
                      range_info=None):
    cap = batch.capacity
    if call.child is not None:
        v = eval_expr(call.child, batch)
        vals_s = _as_values(v, batch)[perm]
        vv_s = jnp.logical_and(_validity_of(v, batch)[perm], mask_s)
    else:
        vals_s = jnp.ones(cap, jnp.int64)
        vv_s = mask_s
    fn = call.fn
    frame = getattr(call, "frame", None)
    if frame is not None:
        # ROWS frame: per-row [idx+lo, idx+hi] clipped to the partition.
        # RANGE frame: per-row value window [key+lo, key+hi] resolved to
        # index bounds by binary search over the sorted key run. Either
        # way the endpoints feed cumulative-sum math for count/sum/avg
        # and sparse-table range queries for min/max.
        lo_off, hi_off = frame[1], frame[2]
        if frame[0] == "range":
            vnum_s, kvalid_s = range_info
            # the contiguous run of valid-key rows inside each partition
            # (nulls sort together at one end and are excluded from the
            # value window; a null-key row's frame is its peer group)
            nn_start = jnp.full(cap, cap, jnp.int32).at[seg_id].min(
                jnp.where(kvalid_s, idx, cap))
            nn_end = jnp.full(cap, -1, jnp.int32).at[seg_id].max(
                jnp.where(kvalid_s, idx, -1))
            nns, nne = nn_start[seg_id], nn_end[seg_id]
            vsearch = jnp.where(kvalid_s, vnum_s,
                                jnp.zeros((), vnum_s.dtype))
            before = idx < nns  # null run precedes (or no valid run)
            null_lo = jnp.where(before, start_of, nne + 1)
            null_hi = jnp.where(before, jnp.minimum(nns - 1, end_of),
                                end_of)
            if lo_off is None:
                raw_lo = start_of
            else:
                found = _bsearch(vsearch, nns, nne, vnum_s + lo_off,
                                 strict=False)
                raw_lo = jnp.where(kvalid_s, found, null_lo)
            if hi_off is None:
                raw_hi = end_of
            else:
                found = _bsearch(vsearch, nns, nne, vnum_s + hi_off,
                                 strict=True) - 1
                raw_hi = jnp.where(kvalid_s, found, null_hi)
        else:
            raw_lo = start_of if lo_off is None else idx + lo_off
            raw_hi = end_of if hi_off is None else idx + hi_off
        lo_idx = jnp.maximum(raw_lo, start_of)
        hi_idx = jnp.minimum(raw_hi, end_of)
        empty = hi_idx < lo_idx
        loc = jnp.clip(lo_idx, 0, cap - 1)
        hic = jnp.clip(hi_idx, 0, cap - 1)

        def ranged(c):
            return jnp.where(
                empty, 0,
                c[hic] - jnp.where(lo_idx > 0,
                                   c[jnp.clip(lo_idx - 1, 0, cap - 1)], 0))

        if fn in ("first_value", "last_value", "nth_value"):
            # frame-edge picks (null when the frame is empty/too short)
            if fn == "nth_value":
                raw = loc + call.offset - 1
                pos = jnp.clip(raw, 0, cap - 1)
                short = raw > hic
            else:
                pos = loc if fn == "first_value" else hic
                short = jnp.zeros(cap, bool)
            ok = jnp.logical_and(mask_s, jnp.logical_and(
                jnp.logical_not(jnp.logical_or(empty, short)), vv_s[pos]))
            return vals_s[pos], ok
        cnt = jnp.cumsum(vv_s.astype(jnp.int64))
        run_cnt = ranged(cnt)
        if fn == "count":
            return run_cnt, mask_s
        if fn in ("min", "max"):
            # sparse table: level k holds op over x[i : i+2^k]; a range of
            # length L is covered by two overlapping power-of-two spans
            big = _ident(fn, vals_s.dtype)
            op = jnp.minimum if fn == "min" else jnp.maximum
            x = jnp.where(vv_s, vals_s, big)
            levels, step = [x], 1
            while step * 2 <= cap:
                prev = levels[-1]
                shifted = jnp.concatenate(
                    [prev[step:], jnp.full(step, big, x.dtype)])
                levels.append(op(prev, shifted))
                step *= 2
            flat = jnp.stack(levels).reshape(-1)
            length = jnp.maximum(hic - loc + 1, 1).astype(jnp.int64)
            k = jnp.clip(63 - jax.lax.clz(length), 0, len(levels) - 1)
            pow2 = jnp.left_shift(jnp.int64(1), k)
            a = flat[k * cap + loc]
            b = flat[k * cap + jnp.clip(hic - pow2 + 1, 0, cap - 1)]
            res = op(a, b)
            ok = jnp.logical_and(mask_s, jnp.logical_and(
                jnp.logical_not(empty), run_cnt > 0))
            return res, ok
        cs = jnp.cumsum(jnp.where(vv_s, vals_s, 0))
        run_sum = ranged(cs)
        if fn == "avg":
            return (run_sum.astype(jnp.float64)
                    / jnp.maximum(run_cnt, 1).astype(jnp.float64),
                    jnp.logical_and(mask_s, run_cnt > 0))
        return run_sum, jnp.logical_and(mask_s, run_cnt > 0)
    running = bool(call.order_by)
    if not running:
        # whole-partition frame: segment totals broadcast
        if fn == "count":
            tot = jnp.zeros(cap, jnp.int64).at[seg_id].add(vv_s.astype(jnp.int64))
            return tot[seg_id], mask_s
        contrib = jnp.where(vv_s, vals_s, 0)
        if fn in ("sum", "avg"):
            s = jnp.zeros(cap, vals_s.dtype).at[seg_id].add(contrib)
            c = jnp.zeros(cap, jnp.int64).at[seg_id].add(vv_s.astype(jnp.int64))
            if fn == "avg":
                return (s[seg_id].astype(jnp.float64)
                        / jnp.maximum(c[seg_id], 1).astype(jnp.float64),
                        jnp.logical_and(mask_s, c[seg_id] > 0))
            return s[seg_id], jnp.logical_and(mask_s, c[seg_id] > 0)
        big = _ident(fn, vals_s.dtype)
        contrib = jnp.where(vv_s, vals_s, big)
        red = (jnp.full(cap, big, vals_s.dtype).at[seg_id].min(contrib)
               if fn == "min" else
               jnp.full(cap, _ident("max", vals_s.dtype), vals_s.dtype)
               .at[seg_id].max(jnp.where(vv_s, vals_s, _ident("max", vals_s.dtype))))
        c = jnp.zeros(cap, jnp.int64).at[seg_id].add(vv_s.astype(jnp.int64))
        return red[seg_id], jnp.logical_and(mask_s, c[seg_id] > 0)
    # running (RANGE … CURRENT ROW): inclusive cumsum evaluated at the END
    # of each row's peer group, offset by the segment start
    cnt = jnp.cumsum(vv_s.astype(jnp.int64))
    run_cnt = cnt[peer_last_of] - jnp.where(start_of > 0, cnt[start_of - 1], 0)
    if fn == "count":
        return run_cnt, mask_s
    if fn in ("sum", "avg"):
        cs = jnp.cumsum(jnp.where(vv_s, vals_s, 0))
        run_sum = cs[peer_last_of] - jnp.where(start_of > 0,
                                               cs[start_of - 1], 0)
        if fn == "avg":
            return (run_sum.astype(jnp.float64)
                    / jnp.maximum(run_cnt, 1).astype(jnp.float64),
                    jnp.logical_and(mask_s, run_cnt > 0))
        return run_sum, jnp.logical_and(mask_s, run_cnt > 0)
    # running min/max: segmented scan (reset at segment starts)
    big = _ident(fn, vals_s.dtype)
    x = jnp.where(vv_s, vals_s, big)
    reset = start_of == idx

    def combine(a, b):
        af, av = a
        bf, bv = b
        if fn == "min":
            v = jnp.where(bf, bv, jnp.minimum(av, bv))
        else:
            v = jnp.where(bf, bv, jnp.maximum(av, bv))
        return jnp.logical_or(af, bf), v

    _, scanned = jax.lax.associative_scan(combine, (reset, x))
    return scanned[peer_last_of], jnp.logical_and(mask_s, run_cnt > 0)


def _ident(fn: str, dtype):
    if fn == "min":
        return (jnp.asarray(jnp.inf, dtype)
                if jnp.issubdtype(dtype, jnp.floating)
                else jnp.asarray(jnp.iinfo(dtype).max, dtype))
    return (jnp.asarray(-jnp.inf, dtype)
            if jnp.issubdtype(dtype, jnp.floating)
            else jnp.asarray(jnp.iinfo(dtype).min, dtype))


def _window_shift(call: WindowCall, batch: Batch, perm, mask_s,
                  start_of, end_of, idx):
    cap = batch.capacity
    v = eval_expr(call.child, batch)
    vals_s = _as_values(v, batch)[perm]
    vv_s = jnp.logical_and(_validity_of(v, batch)[perm], mask_s)
    off = call.offset if call.fn == "lag" else -call.offset
    src = idx - off
    in_seg = jnp.logical_and(src >= start_of, src <= end_of)
    safe = jnp.clip(src, 0, cap - 1)
    res = jnp.where(in_seg, vals_s[safe], 0)
    valid = jnp.where(in_seg, vv_s[safe], False)
    if call.default is not None:
        res = jnp.where(in_seg, res, jnp.asarray(call.default, vals_s.dtype))
        valid = jnp.where(in_seg, valid, True)
    return res, jnp.logical_and(valid, mask_s)
