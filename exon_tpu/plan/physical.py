"""Physical operators: streaming device-batch execution.

Execution model: each operator transforms an iterator of
fixed-capacity device batches. Per-batch work (predicate eval, compaction,
partial aggregation, join probe) is jit-compiled once per capacity bucket and
streamed; host↔device sync happens only at operator breakers (final
aggregate merge, sort, join build) — the design analog of the reference's
tokio FileStream pipelines (exon-core/src/datasources/*/scanner.rs) with XLA
replacing the per-row loops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import datatypes as dt
from ..batch import (Batch, DictColumn, FixedColumn, Schema, VarColumn,
                     bucket_capacity)
from ..errors import ExecutionError, PlanError
from ..ops import aggregate as agg_ops
from ..ops import layout as layout_ops
from .expressions import (AggregateCall, Alias, ColumnRef, Expr, as_bool_mask,
                          eval_expr)


class PhysicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def children(self) -> list["PhysicalPlan"]:
        return []

    # -- conveniences -------------------------------------------------------

    def collect_arrow(self):
        import pyarrow as pa

        tables = [b.to_arrow() for b in host_rooted(self).batches()]
        pa_schema = None
        batches = []
        for rb in tables:
            if rb.num_rows:
                pa_schema = rb.schema
                batches.append(rb)
        if not batches:
            fields = []
            from ..batch import arrow_type

            for f in self.schema().all_fields:
                fields.append(pa.field(f.name, arrow_type(f.dtype), f.nullable))
            return pa.table({f.name: pa.array([], f.type) for f in fields},
                            schema=pa.schema(fields))
        return pa.Table.from_batches(batches)

    def count_rows(self) -> int:
        total = 0
        for b in self.batches():
            total += b.num_rows_host()
        return total


# ---------------------------------------------------------------------------


def host_rooted(plan: "PhysicalPlan") -> "PhysicalPlan":
    """Root bare scans stream host batches directly: the device adds no
    compute, so a round trip through it is pure cost. Shared by
    collect_arrow and the HTTP server's streaming path."""
    if isinstance(plan, ScanExec) and plan.to_device:
        return dataclasses.replace(plan, to_device=False)
    return plan


@dataclasses.dataclass
class ScanExec(PhysicalPlan):
    """Leaf scan: host decode stream → device batches.

    ``source`` yields host Batches; they are padded to bucketed capacities
    and transferred. Mirrors <FMT>Scan + FileOpener in the reference
    (e.g. exon-core/src/datasources/fasta/scanner.rs:101-178).
    """

    out_schema: Schema
    source: Callable[[], Iterator[Batch]]
    to_device: bool = True

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        for host_batch in self.source():
            yield host_batch.to_device() if self.to_device else host_batch


@dataclasses.dataclass
class FilterExec(PhysicalPlan):
    predicate: Expr
    input: PhysicalPlan
    compact: bool = True  # False → leave rows, only used before aggregates

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        step = _jit_filter_step(self.predicate)
        for b in self.input.batches():
            yield step(b)


@functools.cache
def _jit_filter_step(predicate: Expr):
    from .expressions import contains_host_fn

    def step(batch: Batch) -> Batch:
        mask = as_bool_mask(eval_expr(predicate, batch), batch)
        return layout_ops.filter_batch(batch, mask)

    return step if contains_host_fn(predicate) else jax.jit(step)


@dataclasses.dataclass
class ProjectExec(PhysicalPlan):
    exprs: list[Expr]
    out_schema: Schema
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        step = _jit_project_step(tuple(self.exprs), self.out_schema)
        for b in self.input.batches():
            yield step(b)


@functools.cache
def _jit_project_step(exprs: tuple, out_schema: Schema):
    from .expressions import contains_host_fn

    def step(batch: Batch) -> Batch:
        cols = []
        for e in exprs:
            v = eval_expr(e, batch)
            cols.append(_to_column(v, batch))
        return Batch(out_schema, cols, batch.length)

    if any(contains_host_fn(e) for e in exprs):
        return step
    return jax.jit(step)


def _to_column(v, batch: Batch):
    from ..batch import ListColumn, StructColumn

    if isinstance(v, (FixedColumn, VarColumn, DictColumn, ListColumn,
                      StructColumn)):
        return v
    if isinstance(v, (int, float, bool)):
        arr = jnp.full(batch.capacity, v)
        return FixedColumn(arr, batch.row_mask())
    if isinstance(v, str):
        # constant string column: same bytes in every row
        b = v.encode()
        cap = batch.capacity
        vals = jnp.asarray(np.tile(np.frombuffer(b, np.uint8), max(cap, 1)))
        offs = jnp.asarray((np.arange(cap + 1) * len(b)).astype(np.int32))
        return VarColumn(vals, offs, batch.row_mask())
    arr = jnp.asarray(v)
    if arr.ndim == 0:
        # scalar expression result (literal arithmetic, scalar subquery):
        # broadcast to the batch like the python-scalar case above
        arr = jnp.full(batch.capacity, arr)
    return FixedColumn(arr, batch.row_mask())


# ---------------------------------------------------------------------------
# Aggregate
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AggregateExec(PhysicalPlan):
    """Group-by + aggregate with streaming per-batch partials.

    Device does the per-row work (key packing, segment reductions); the host
    merges the per-batch group partials (small) — the data-parallel analog of
    DataFusion's two-phase repartitioned hash aggregate (config/mod.rs:31).
    """

    group_exprs: list[Expr]
    agg_calls: list[AggregateCall]
    out_schema: Schema
    input: PhysicalPlan
    pre_filter: Optional[Expr] = None  # fused Filter predicate (mask only)

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        if any(c.fn in _HOLISTIC_FNS for c in self.agg_calls) or \
                self._string_minmax():
            yield self._holistic()
            return
        if not self.group_exprs:
            yield self._ungrouped()
            return
        yield self._grouped()

    def _string_minmax(self) -> bool:
        """MIN/MAX over utf8 needs exact lexicographic compare — host
        materializing path (DataFusion's Min/MaxAccumulator handles utf8
        natively; the device partials here are numeric-only)."""
        from .planner import infer_expr_field

        in_schema = self.input.schema()
        for c in self.agg_calls:
            if c.fn in ("min", "max") and c.child is not None:
                try:
                    k = infer_expr_field(c.child, in_schema).dtype.kind.value
                except Exception:
                    return True
                if k in ("utf8", "large_utf8", "dictionary", "binary"):
                    return True
        return False

    # -- holistic (materializing) aggregates ---------------------------------

    def _holistic(self) -> Batch:
        """median / array_agg / string_agg need every value, not a partial:
        evaluate group+child expressions on device, collect to host, group
        exactly (first-seen order). Mirrors DataFusion's materializing
        accumulators (median.rs/array_agg.rs are host Rust there too)."""
        import pyarrow as pa

        from ..batch import arrow_type
        from .expressions import Alias
        from .planner import infer_expr_field

        inner: PhysicalPlan = self.input
        if self.pre_filter is not None:
            inner = FilterExec(self.pre_filter, inner)
        in_schema = inner.schema()
        exprs: list[Expr] = []
        names: list[str] = []
        for i, g in enumerate(self.group_exprs):
            exprs.append(Alias(g, f"__g{i}"))
            names.append(f"__g{i}")
        child_col: list[Optional[str]] = []
        for j, call in enumerate(self.agg_calls):
            if call.child is None:
                child_col.append(None)
            else:
                exprs.append(Alias(call.child, f"__a{j}"))
                names.append(f"__a{j}")
                child_col.append(f"__a{j}")
        fields = tuple(
            dt.Field(nm, infer_expr_field(e.child, in_schema).dtype, True)
            for e, nm in zip(exprs, names))
        proj = ProjectExec(exprs, Schema(fields), inner)
        tabs = [b.to_arrow() for b in proj.batches()]
        if tabs:
            tab = pa.Table.from_batches(tabs)
        else:
            tab = pa.table({nm: pa.array([], type=arrow_type(f.dtype))
                            for nm, f in zip(names, fields)})
        n_group = len(self.group_exprs)
        gcols = [tab.column(f"__g{i}").to_pylist() for i in range(n_group)]
        n_rows = tab.num_rows
        acols = {nm: tab.column(nm).to_pylist()
                 for nm in names[n_group:]}
        # exact group-by, first-seen emission order
        order: dict = {}
        rows_of: list[list[int]] = []
        for r in range(n_rows):
            key = tuple(col[r] for col in gcols)
            gi = order.get(key)
            if gi is None:
                gi = len(rows_of)
                order[key] = gi
                rows_of.append([])
            rows_of[gi].append(r)
        if not self.group_exprs and not rows_of:
            rows_of = [[]]
            order[()] = 0
        out_fields = self.out_schema.all_fields
        arrays = []
        keys_in_order = list(order.keys())
        for i in range(n_group):
            vals = [k[i] for k in keys_in_order]
            arrays.append(pa.array(vals,
                                   type=arrow_type(out_fields[i].dtype)))
        for j, call in enumerate(self.agg_calls):
            cvals = acols.get(child_col[j]) if child_col[j] else None
            outs = [_holistic_value(call, cvals, rows)
                    for rows in rows_of]
            arrays.append(pa.array(
                outs, type=arrow_type(out_fields[n_group + j].dtype)))
        rb = pa.record_batch(arrays, names=self.out_schema.names)
        return Batch.from_arrow(rb, self.out_schema).to_device()

    # -- ungrouped ----------------------------------------------------------

    def _ungrouped(self) -> Batch:
        if (self.pre_filter is None and isinstance(self.input, ScanExec)
                and all(c.fn == "count" and c.child is None
                        for c in self.agg_calls)):
            # COUNT(*) over a bare scan evaluates no columns: sum row
            # counts during ingest (DataFusion's count-over-scan shape).
            # No device program, no transfers — the scan stays pure host
            # ingest.
            total = 0
            for hb in self.input.source():
                n = hb.length
                total += int(n) if isinstance(n, (int, np.integer)) \
                    else hb.num_rows_host()
            partials = [np.int64(total) for _ in self.agg_calls]
            cols, _n = _finalize_ungrouped(partials, self.agg_calls,
                                           self.out_schema)
            return Batch(self.out_schema, cols, np.int32(1))
        step = _jit_ungrouped_partial(tuple(self.agg_calls), self.pre_filter)
        # accumulate per-batch partials as *device* values — dispatch stays
        # async, one host sync at the end instead of one per batch
        device_partials: list = []
        for b in self.input.batches():
            device_partials.append(step(b))
        if not device_partials:
            partials = _empty_ungrouped(self.agg_calls)
        else:
            host = jax.device_get(device_partials)  # ONE sync for the stream
            partials = host[0]
            for p in host[1:]:
                partials = _merge_ungrouped(partials, p, self.agg_calls)
        cols, n = _finalize_ungrouped(partials, self.agg_calls, self.out_schema)
        # host-resident 1-row result: downstream jit steps accept numpy
        # inputs, and collect/to_arrow skips a blocking device round-trip
        return Batch(self.out_schema, cols, np.int32(1))

    # -- grouped ------------------------------------------------------------

    def _grouped(self) -> Batch:
        """Streaming grouped aggregate with DEVICE-side merge.

        Per batch: one jit step builds a compacted GroupTable (sorted key
        hashes, partials, first-seen ranks, representative key values).
        Tables accumulate asynchronously and fold into the running state in
        chunks; the only host syncs are one scalar per fold (to re-bucket
        state capacity) — no per-batch round-trips, no Python dict, scales
        to millions of distinct keys. Replaces the role of DataFusion's
        repartitioned hash aggregate (exon-core/src/config/mod.rs:31).
        """
        n_group = len(self.group_exprs)
        rep_schema = Schema(tuple(self.out_schema.all_fields[:n_group]))
        step = _jit_grouped_partial(tuple(self.group_exprs),
                                    tuple(self.agg_calls), rep_schema,
                                    self.pre_filter)
        merge = _merge_group_tables_fn(tuple(self.agg_calls))
        state: Optional[GroupTable] = None
        pending: list[GroupTable] = []
        pending_cap = 0
        base_rank = 0
        for b in self.input.batches():
            pending.append(step(b, jnp.int64(base_rank)))
            base_rank += b.capacity
            pending_cap += b.capacity
            state_cap = state.keys.shape[0] if state is not None else 0
            if pending_cap >= max(1 << 16, state_cap):
                state = merge(([state] if state is not None else []) + pending)
                pending, pending_cap = [], 0
                state = _compact_group_table(state)
        if pending:
            state = merge(([state] if state is not None else []) + pending)
        if state is None:
            return self._empty_grouped()
        fin = _jit_finalize_grouped(tuple(self.agg_calls), self.out_schema,
                                    n_group)
        return fin(state)

    def _empty_grouped(self) -> Batch:
        return _empty_batch(self.out_schema)


# partial accumulator per agg call:
#   count → int; sum → (sum, count_nonnull); min/max → (val, seen)
#   avg → (sum, count)


@functools.cache
def _jit_ungrouped_partial(agg_calls: tuple, pre_filter=None):
    @jax.jit
    def step(batch: Batch):
        out = []
        if pre_filter is None and all(
                c.fn == "count" and c.child is None for c in agg_calls):
            # COUNT(*): the row count IS the partial — no mask reduction,
            # and it stays correct for zero-column (projection-free) batches
            # whose capacity is 0
            n = jnp.asarray(batch.length, jnp.int64)
            return [n for _ in agg_calls]
        mask = batch.row_mask()
        if pre_filter is not None:
            mask = jnp.logical_and(
                mask, as_bool_mask(eval_expr(pre_filter, batch), batch))
        for call in agg_calls:
            out.append(_partial_for(call, batch, mask, None, 1))
        return out

    return step


def _values_for_call(call: AggregateCall, batch: Batch, mask):
    if call.child is None:
        return None, mask
    v = eval_expr(call.child, batch)
    from .expressions import _as_values, _validity_of

    valid = jnp.logical_and(mask, _validity_of(v, batch))
    if isinstance(v, VarColumn) and call.fn == "count":
        return None, valid
    vals = _as_values(v, batch)
    return vals, valid


# second-moment family: partial = (Σx, Σx², count) in float64
_VAR_FNS = ("stddev", "stddev_samp", "stddev_pop", "var", "variance",
            "var_samp", "var_pop")
# materialize-everything aggregates (host finalize, like DataFusion's
# median/array_agg accumulators)
_HOLISTIC_FNS = ("median", "array_agg", "string_agg")


def _partial_for(call: AggregateCall, batch: Batch, mask, gids, num_groups: int):
    """Compute this call's partial; grouped if gids is not None."""
    vals, valid = _values_for_call(call, batch, mask)
    fn = call.fn
    if gids is None:
        if fn == "count":
            return agg_ops.ungrouped_reduce(None, valid, "count")
        if fn in ("sum", "avg"):
            s = agg_ops.ungrouped_reduce(vals, valid, "sum")
            c = agg_ops.ungrouped_reduce(None, valid, "count")
            return (s, c)
        if fn in ("min", "max"):
            m = agg_ops.ungrouped_reduce(vals, valid, fn)
            c = agg_ops.ungrouped_reduce(None, valid, "count")
            return (m, c)
        if fn in _VAR_FNS:
            v64 = vals.astype(jnp.float64)
            s = agg_ops.ungrouped_reduce(v64, valid, "sum")
            ss = agg_ops.ungrouped_reduce(v64 * v64, valid, "sum")
            c = agg_ops.ungrouped_reduce(None, valid, "count")
            return (s, ss, c)
        raise PlanError(f"aggregate {fn} unsupported")
    else:
        if fn == "count":
            return agg_ops.grouped_reduce_codes(gids, valid, None, "count", num_groups)
        if fn in ("sum", "avg"):
            s = agg_ops.grouped_reduce_codes(gids, valid, vals, "sum", num_groups)
            c = agg_ops.grouped_reduce_codes(gids, valid, None, "count", num_groups)
            return (s, c)
        if fn in ("min", "max"):
            m = agg_ops.grouped_reduce_codes(gids, valid, vals, fn, num_groups)
            c = agg_ops.grouped_reduce_codes(gids, valid, None, "count", num_groups)
            return (m, c)
        if fn in _VAR_FNS:
            v64 = vals.astype(jnp.float64)
            s = agg_ops.grouped_reduce_codes(gids, valid, v64, "sum", num_groups)
            ss = agg_ops.grouped_reduce_codes(gids, valid, v64 * v64, "sum",
                                              num_groups)
            c = agg_ops.grouped_reduce_codes(gids, valid, None, "count", num_groups)
            return (s, ss, c)
        raise PlanError(f"aggregate {fn} unsupported")


def _holistic_value(call: AggregateCall, cvals, rows: list):
    """Finalize one group of a holistic aggregate from host values."""
    import numpy as _np

    fn = call.fn
    if fn == "count":
        if cvals is None:
            return len(rows)
        return sum(1 for r in rows if cvals[r] is not None)
    xs = [] if cvals is None else [cvals[r] for r in rows
                                   if cvals[r] is not None]
    if fn == "array_agg":
        return xs if xs else ([] if rows else None)
    if fn == "string_agg":
        sep = call.extra[0] if call.extra else ","
        strs = [x if isinstance(x, str) else str(x) for x in xs]
        return (sep or "").join(strs) if strs else None
    if not xs:
        return None
    if fn == "median":
        med = _np.median(_np.asarray(xs, dtype=_np.float64))
        if all(isinstance(x, (int, _np.integer)) for x in xs):
            return int(_np.rint(med))
        return float(med)
    if fn == "sum":
        return sum(xs)
    if fn == "avg":
        return float(sum(xs)) / len(xs)
    if fn == "min":
        return min(xs)
    if fn == "max":
        return max(xs)
    if fn in _VAR_FNS:
        a = _np.asarray(xs, dtype=_np.float64)
        pop = fn.endswith("_pop")
        if (not pop and len(a) < 2) or len(a) < 1:
            return None
        var = a.var(ddof=0 if pop else 1)
        return float(_np.sqrt(var)) if fn.startswith("stddev") else float(var)
    raise PlanError(f"aggregate {fn} unsupported in holistic path")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GroupTable:
    """Compacted group-by state on device.

    Slots [0, count) hold live groups sorted by key hash; padding slots
    have keys/first = INT64_MAX. ``reps`` carries the actual group-key
    VALUES (representative first-seen row per group) so output never
    round-trips hashes through the host.
    """

    keys: Any      # int64[cap] sorted
    first: Any     # int64[cap] global first-occurrence rank (emission order)
    partials: tuple  # per agg call: array[cap] or tuple of arrays[cap]
    reps: Batch    # group-key value columns, cap rows
    count: Any     # int32 scalar

    def tree_flatten(self):
        return (self.keys, self.first, self.partials, self.reps, self.count), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


_I64MAX = jnp.iinfo(jnp.int64).max


@functools.cache
def _jit_grouped_partial(group_exprs: tuple, agg_calls: tuple,
                         rep_schema: Schema, pre_filter=None):
    @jax.jit
    def step(batch: Batch, base_rank) -> GroupTable:
        mask = batch.row_mask()
        if pre_filter is not None:
            mask = jnp.logical_and(
                mask, as_bool_mask(eval_expr(pre_filter, batch), batch))
        keys = _group_key_i64(group_exprs, batch)
        gids, gkeys, num_groups = agg_ops.sort_group_ids(keys, mask)
        cap = batch.capacity
        # representative (first) row index per group
        first_idx = jnp.full(cap, cap, jnp.int32).at[
            jnp.where(mask, gids, cap - 1)
        ].min(jnp.where(mask, jnp.arange(cap, dtype=jnp.int32), cap))
        slot = jnp.arange(cap, dtype=jnp.int32)
        first = jnp.where(slot < num_groups,
                          base_rank + first_idx.astype(jnp.int64), _I64MAX)
        partials = tuple(_partial_for(call, batch, mask, gids, cap)
                         for call in agg_calls)
        rep_cols = []
        for e in group_exprs:
            v = eval_expr(e, batch)
            if isinstance(v, DictColumn):
                v = layout_ops.dict_to_var(v)
            elif not isinstance(v, (FixedColumn, VarColumn)):
                v = FixedColumn(jnp.asarray(v), mask)
            rep_cols.append(v)
        rep_full = Batch(rep_schema, rep_cols, batch.length)
        reps = layout_ops.take_batch(rep_full, first_idx, num_groups)
        return GroupTable(gkeys, first, partials, reps, num_groups)

    return step


@functools.cache
def _merge_group_tables_fn(agg_calls: tuple):
    """n-way GroupTable merge, jitted (retraces per distinct shape set)."""

    @jax.jit
    def merge(tables: list[GroupTable]) -> GroupTable:
        if len(tables) == 1:
            return tables[0]
        caps = [t.keys.shape[0] for t in tables]
        cap = sum(caps)
        keys = jnp.concatenate([t.keys for t in tables])
        first = jnp.concatenate([t.first for t in tables])
        mask = jnp.concatenate([
            jnp.arange(c, dtype=jnp.int32) < t.count
            for c, t in zip(caps, tables)])
        gids, gkeys, ng = agg_ops.sort_group_ids(keys, mask)
        merged = []
        for j, call in enumerate(agg_calls):
            comps = [t.partials[j] for t in tables]
            if isinstance(comps[0], tuple):
                cat = tuple(jnp.concatenate([c[i] for c in comps])
                            for i in range(len(comps[0])))
            else:
                cat = jnp.concatenate(comps)
            merged.append(_merge_partial(call, gids, mask, cat, cap))
        first_m = jnp.full(cap, _I64MAX, jnp.int64).at[
            jnp.clip(gids, 0, cap - 1)].min(jnp.where(mask, first, _I64MAX))
        # winner (earliest first-seen) row index per merged group
        packed = jnp.where(mask,
                           first * cap + jnp.arange(cap, dtype=jnp.int64),
                           _I64MAX)
        best = jnp.full(cap, _I64MAX, jnp.int64).at[
            jnp.clip(gids, 0, cap - 1)].min(packed)
        rep_idx = jnp.clip(best % cap, 0, cap - 1).astype(jnp.int32)
        reps_cat, _ = layout_ops.concat_device_batches([t.reps for t in tables])
        reps = layout_ops.take_batch(reps_cat, rep_idx, ng)
        return GroupTable(gkeys, first_m, tuple(merged), reps, ng)

    return merge


def _merge_partial(call: AggregateCall, gids, mask, cat, cap):
    fn = call.fn
    if fn == "count":
        return agg_ops.grouped_reduce_codes(gids, mask, cat, "sum", cap)
    if fn in _VAR_FNS:
        return tuple(agg_ops.grouped_reduce_codes(gids, mask, c, "sum", cap)
                     for c in cat)
    s_fn = {"sum": "sum", "avg": "sum", "min": "min", "max": "max"}[fn]
    smask = mask
    if fn in ("min", "max"):
        # identity fills from all-null partials must not win the reduce
        smask = jnp.logical_and(mask, cat[1] > 0)
    s = agg_ops.grouped_reduce_codes(gids, smask, cat[0], s_fn, cap)
    c = agg_ops.grouped_reduce_codes(gids, mask, cat[1], "sum", cap)
    return (s, c)


def _compact_group_table(state: GroupTable) -> GroupTable:
    """Shrink state arrays to the true group count's capacity bucket
    (host-driven: one scalar sync per fold — the only sync in the stream)."""
    from ..batch import bucket_capacity

    cap = state.keys.shape[0]
    ng = int(jax.device_get(state.count))
    newcap = bucket_capacity(ng, 128)
    if newcap >= cap:
        return state

    def cut(x):
        return x[:newcap]

    partials = tuple(tuple(cut(c) for c in p) if isinstance(p, tuple)
                     else cut(p) for p in state.partials)
    rep_cols = []
    for col in state.reps.columns:
        if isinstance(col, VarColumn):
            vbytes = int(jax.device_get(col.offsets[newcap]))
            vcap = bucket_capacity(max(vbytes, 1), 128)
            vcap = min(vcap, col.value_capacity)
            rep_cols.append(VarColumn(col.values[:vcap],
                                      col.offsets[:newcap + 1],
                                      col.validity[:newcap]))
        elif isinstance(col, FixedColumn):
            rep_cols.append(FixedColumn(cut(col.values), cut(col.validity)))
        else:
            raise PlanError(f"group key column {type(col)} in state")
    reps = Batch(state.reps.schema, rep_cols, state.count)
    return GroupTable(cut(state.keys), cut(state.first), partials,
                      reps, state.count)


@functools.cache
def _jit_finalize_grouped(agg_calls: tuple, out_schema: Schema, n_group: int):
    fields = out_schema.all_fields

    @jax.jit
    def fin(state: GroupTable) -> Batch:
        cap = state.keys.shape[0]
        slot = jnp.arange(cap, dtype=jnp.int32)
        live = slot < state.count
        order = jnp.argsort(jnp.where(live, state.first, _I64MAX),
                            stable=True).astype(jnp.int32)
        reps = layout_ops.take_batch(state.reps, order, state.count)
        cols = list(reps.columns)
        for j, call in enumerate(agg_calls):
            p = state.partials[j]
            f = fields[n_group + j]
            npdt = dt.numpy_dtype(f.dtype)
            if call.fn == "count":
                vals = p[order].astype(npdt)
                valid = live[order]
            elif call.fn in _VAR_FNS:
                s, ss, c = p[0][order], p[1][order], p[2][order]
                cf = jnp.maximum(c, 1).astype(jnp.float64)
                m2 = jnp.maximum(ss - s * s / cf, 0.0)
                pop = call.fn.endswith("_pop")
                denom = cf if pop else jnp.maximum(cf - 1.0, 1.0)
                var = m2 / denom
                vals = jnp.sqrt(var) if call.fn.startswith("stddev") else var
                vals = vals.astype(npdt)
                minc = 1 if pop else 2
                valid = jnp.logical_and(live[order], c >= minc)
                vals = jnp.where(valid, vals, jnp.zeros((), npdt))
            else:
                s, c = p[0][order], p[1][order]
                nonnull = jnp.logical_and(live[order], c > 0)
                if call.fn == "avg":
                    vals = s.astype(jnp.float64) / jnp.maximum(
                        c, 1).astype(jnp.float64)
                else:
                    vals = s
                vals = jnp.where(nonnull, vals.astype(npdt),
                                 jnp.zeros((), npdt))
                valid = nonnull
            cols.append(FixedColumn(vals, valid))
        return Batch(out_schema, cols, state.count)

    return fin


_NULL_KEY_SENT = np.int64(np.uint64(0x9E3779B97F4A7C15))


def _group_key_i64(group_exprs: tuple, batch: Batch) -> jnp.ndarray:
    """Combine group expressions into a single int64 key per row.

    A single fixed-width key packs exactly; var-width/dict keys use a
    full-content polynomial hash mod 2^64 (every byte contributes), so
    cross-batch merges key on content, not representation. Joins re-verify
    with byte-equality residuals; group-by relies on the 64-bit hash
    (collision odds ~ n^2 / 2^64).

    NULL values mix a fixed sentinel into their part, so a NULL key forms
    its own group distinct from any real value (SQL GROUP BY semantics —
    NULLs group together; previously NULL aliased the slot's zero fill).
    Joins additionally EXCLUDE null-key rows from matching via
    _group_key_valid (SQL equality: NULL matches nothing, not even NULL).
    """
    parts = []
    for e in group_exprs:
        v = eval_expr(e, batch)
        if isinstance(v, DictColumn):
            # map codes through the content hash of their vocab strings so
            # dict- and var-encoded sides of a join/group agree on keys
            table = np.asarray([_hash_bytes_host(s.encode()) for s in v.vocab]
                               or [0], dtype=np.int64)
            p = jnp.asarray(table)[jnp.clip(v.codes, 0, len(table) - 1)]
            parts.append(jnp.where(jnp.asarray(v.validity), p,
                                   _NULL_KEY_SENT))
        elif isinstance(v, FixedColumn):
            if jnp.issubdtype(v.values.dtype, jnp.floating):
                p = jax.lax.bitcast_convert_type(
                    v.values.astype(jnp.float64), jnp.int64)
            else:
                p = v.values.astype(jnp.int64)
            parts.append(jnp.where(jnp.asarray(v.validity), p,
                                   _NULL_KEY_SENT))
        elif isinstance(v, VarColumn):
            parts.append(jnp.where(jnp.asarray(v.validity), _hash_var(v),
                                   _NULL_KEY_SENT))
        else:
            arr = jnp.asarray(v).astype(jnp.int64)
            if arr.ndim == 0:
                # constant key (CROSS JOIN lowers to a Literal pair)
                arr = jnp.full(batch.capacity, arr, jnp.int64)
            parts.append(arr)
    key = parts[0]
    for p in parts[1:]:
        k = key.astype(jnp.uint64) * jnp.uint64(0x100000001B3) \
            + p.astype(jnp.uint64)
        key = k.astype(jnp.int64)
    return key


def _group_key_valid(group_exprs: tuple, batch: Batch) -> jnp.ndarray:
    """Per-row mask: every key expression non-NULL. Joins AND this into
    their match masks — SQL equality never matches through NULL."""
    ok = batch.row_mask()
    for e in group_exprs:
        v = eval_expr(e, batch)
        if isinstance(v, (FixedColumn, VarColumn, DictColumn)):
            ok = jnp.logical_and(ok, jnp.asarray(v.validity))
    return ok


_FNV_PRIME = 1099511628211          # 2^40 + 2^8 + 0xb3
_HASH_SALT = 0x9E3779B97F4A7C15


def _splitmix_host(h: int) -> int:
    M = (1 << 64) - 1
    h = (h + 0x9E3779B97F4A7C15) & M
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & M
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & M
    return h ^ (h >> 31)


def _hash_bytes_host(s: bytes) -> int:
    """Host mirror of _hash_var: full-content FNV-style polynomial mod
    2^64 (Horner form) + splitmix finalizer, returned as signed int64."""
    M = (1 << 64) - 1
    h = 0
    for b in s:
        h = (h * _FNV_PRIME + b + 1) & M
    h = (h + len(s) * _HASH_SALT) & M
    h = _splitmix_host(h)
    return h - (1 << 64) if h >= (1 << 63) else h


def _pow_mod64(base: int, exp: jnp.ndarray, max_exp: int) -> jnp.ndarray:
    """base ** exp mod 2^64 elementwise, by square-and-multiply over the
    bits of exp (0 <= exp <= max_exp). A power table built with cumprod
    over a constant would be folded by XLA at compile time, in time
    quadratic in the buffer size."""
    out = jnp.ones(exp.shape, jnp.uint64)
    e = exp.astype(jnp.uint64)
    sq = base
    for bit in range(max(max_exp, 1).bit_length()):
        out = jnp.where((e >> jnp.uint64(bit)) & jnp.uint64(1),
                        out * jnp.uint64(sq), out)
        sq = (sq * sq) & ((1 << 64) - 1)
    return out


def _hash_var(v: VarColumn) -> jnp.ndarray:
    """Full-content polynomial hash per row, mod 2^64.

    h(row) = Σ_j (byte_j + 1) · P^(len-1-j)  — computed elementwise plus
    one segmented scatter-add over the flat buffer (no per-row loops, no
    prefix truncation: strings differing ANYWHERE differ here).
    """
    vcap = v.value_capacity
    cap = v.capacity
    rid = jnp.clip(layout_ops.byte_row_ids(v.offsets, vcap), 0, cap - 1)
    pos = jnp.arange(vcap, dtype=jnp.int32)
    ends = v.offsets[1:]
    in_row = pos < ends[rid]
    exp = jnp.clip(ends[rid] - 1 - pos, 0, vcap - 1)
    contrib = jnp.where(in_row,
                        (v.values.astype(jnp.uint64) + jnp.uint64(1))
                        * _pow_mod64(_FNV_PRIME, exp, vcap - 1),
                        jnp.uint64(0))
    h = jnp.zeros(cap, jnp.uint64).at[rid].add(contrib)
    lens = layout_ops.row_lengths(v.offsets).astype(jnp.uint64)
    h = h + lens * jnp.uint64(_HASH_SALT)
    # splitmix64 finalizer (matches _splitmix_host)
    h = h + jnp.uint64(0x9E3779B97F4A7C15)
    h = (h ^ (h >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> jnp.uint64(31))
    return h.astype(jnp.int64)


def _merge_ungrouped(a, b, calls):
    return [_merge_agg_value(x, y, c) for x, y, c in zip(a, b, calls)]


def _merge_agg_value(x, y, call: AggregateCall):
    fn = call.fn
    if fn == "count":
        return np.int64(x) + np.int64(y)
    if fn in _VAR_FNS:
        return tuple(a + b for a, b in zip(x, y))
    xs, xc = x
    ys, yc = y
    if fn in ("sum", "avg"):
        return (xs + ys, xc + yc)
    if fn == "min":
        return (min(xs, ys) if xc and yc else (xs if xc else ys), xc + yc)
    if fn == "max":
        return (max(xs, ys) if xc and yc else (xs if xc else ys), xc + yc)
    raise PlanError(fn)


def _empty_ungrouped(calls):
    out = []
    for c in calls:
        if c.fn == "count":
            out.append(np.int64(0))
        elif c.fn in _VAR_FNS:
            out.append((np.float64(0), np.float64(0), np.int64(0)))
        else:
            out.append((np.float64(0), np.int64(0)))
    return out


def _finalize_agg_value(p, call: AggregateCall):
    fn = call.fn
    if fn == "count":
        return int(np.asarray(p).item() if hasattr(p, "item") or isinstance(p, np.ndarray) else p)
    if fn in _VAR_FNS:
        return _finalize_variance(float(p[0]), float(p[1]),
                                  int(np.asarray(p[2])), fn)
    s, c = p[0], p[1]
    c = int(np.asarray(c))
    if fn == "avg":
        return float(s) / c if c else None
    if fn == "sum":
        return _np_item(s) if c else None
    if fn in ("min", "max"):
        return _np_item(s) if c else None
    raise PlanError(fn)


def _finalize_variance(s: float, ss: float, c: int, fn: str):
    pop = fn.endswith("_pop")
    if c < (1 if pop else 2):
        return None
    m2 = max(ss - s * s / c, 0.0)
    var = m2 / (c if pop else c - 1)
    return float(np.sqrt(var)) if fn.startswith("stddev") else float(var)


def _np_item(x):
    a = np.asarray(x)
    return a.item()


def _finalize_ungrouped(partials, calls, out_schema: Schema):
    from ..batch import fixed_column

    cols = []
    for p, call, f in zip(partials, calls, out_schema.all_fields):
        v = _finalize_agg_value(p, call)
        npdt = dt.numpy_dtype(f.dtype)
        arr = np.asarray([0 if v is None else v], dtype=npdt)
        cols.append(fixed_column(arr, np.asarray([v is not None])))
    return cols, 1


# ---------------------------------------------------------------------------
# Sort / Limit / Union / Values
# ---------------------------------------------------------------------------


def concat_batches(schema: Schema, batches: list[Batch]) -> Batch:
    """Concatenate device batches via host Arrow (breaker op)."""
    import pyarrow as pa

    rbs = [b.to_arrow() for b in batches if b.num_rows_host() > 0]
    if not rbs:
        return _empty_batch(schema)
    table = pa.Table.from_batches(rbs).combine_chunks()
    rb = table.to_batches()[0] if table.num_rows else None
    if rb is None:
        return _empty_batch(schema)
    return Batch.from_arrow(rb, schema).to_device()


def _empty_batch(schema: Schema) -> Batch:
    import pyarrow as pa

    from ..batch import arrow_type

    arrays = [pa.array([], arrow_type(f.dtype)) for f in schema.all_fields]
    rb = pa.RecordBatch.from_arrays(arrays, names=schema.names)
    return Batch.from_arrow(rb, schema).to_device()


@dataclasses.dataclass
class RepeatExec(PhysicalPlan):
    """Emit each input row count_expr times (clipped at 0; NULL count → 0).
    Host expansion via one Arrow take per batch — input batches here are
    set-op aggregate outputs (distinct rows + multiplicities), already far
    smaller than the raw streams."""

    count_expr: object  # Expr
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        import pyarrow as pa

        from .expressions import _as_values, _validity_of

        for b in self.input.batches():
            n = b.num_rows_host()
            if n == 0:
                continue
            v = eval_expr(self.count_expr, b)
            cnt = np.asarray(jax.device_get(_as_values(v, b)))[:n]
            ok = np.asarray(jax.device_get(_validity_of(v, b)))[:n]
            cnt = np.clip(np.where(ok, cnt, 0), 0, None).astype(np.int64)
            idx = np.repeat(np.arange(n, dtype=np.int64), cnt)
            if len(idx) == 0:
                continue
            rb = b.to_arrow().take(pa.array(idx))
            yield Batch.from_arrow(rb, self.schema())


@dataclasses.dataclass
class SortExec(PhysicalPlan):
    """ORDER BY as an external run sort.

    Input batches accumulate into bounded *runs* (EXON_TPU_SORT_RUN_ROWS,
    default 2M rows); each run sorts exactly ON DEVICE (stable LSD over the
    sort_key_columns), then spills to host as Arrow plus a byte-comparable
    key column. Sorted runs merge pairwise with np.searchsorted (sequential
    access — measured 4-10x faster than device random gathers at these
    sizes) and the result streams out in bounded chunks, so ORDER BY over a
    25M-row table never materializes one device batch. Replaces the role of
    DataFusion's ExternalSorter (spill-to-disk sort the reference enables
    via repartition_sorts, exon-core/src/config/mod.rs:40-43)."""

    keys: list  # [(Expr, ascending)]
    input: PhysicalPlan
    fetch: Optional[int] = None

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        schema = self.schema()
        merged = self.merged_run()
        if merged is None:
            yield _empty_batch(schema)
            return
        merged_tab = merged[0]
        if self.fetch is not None:
            merged_tab = merged_tab.slice(0, self.fetch)
        yield from _emit_table(merged_tab, schema)

    def merged_run(self) -> Optional[tuple]:
        """Sort the whole input into one merged (arrow table, key matrix,
        chunk widths) run, or None if the input is empty. The distributed
        sort exchanges these per-process runs and merges them with the
        same _merge_runs ladder."""
        import os as _os

        run_rows = int(_os.environ.get("EXON_TPU_SORT_RUN_ROWS", 1 << 21))
        runs: list = []  # (pa.Table, key_cols int64 np [n, C], chunk_list)
        acc: list[Batch] = []
        acc_rows = 0
        # sort directly over a scan: accumulate the HOST decode stream (one
        # bulk device transfer per run) instead of one blocking device
        # round-trip per scan batch
        stream = self.input.batches()
        host_stream = False
        if isinstance(self.input, ScanExec) and self.input.to_device:
            stream = self.input.source()
            host_stream = True
        # plain column keys over a host stream sort entirely host-side,
        # sparing the run a copy to the device and back (key encoding
        # identical to sort_key_columns)
        from .expressions import ColumnRef

        from .expressions import NullsOrder

        def _bare(e):
            return e.child if isinstance(e, NullsOrder) else e

        self._host_sort = host_stream and all(
            isinstance(_bare(e), ColumnRef) for e, _a in self.keys)
        for b in stream:
            n = b.num_rows_host()
            if n == 0:
                continue
            acc.append(b)
            acc_rows += n
            if acc_rows >= run_rows:
                runs.append(self._sorted_run(acc))
                acc, acc_rows = [], 0
        if acc:
            runs.append(self._sorted_run(acc))
        if not runs:
            return None
        asc_flags = [a for _e, a in self.keys]
        return _merge_runs(runs, asc_flags)

    def _sorted_run(self, acc: list) -> tuple:
        """Sort one run; spill (arrow table, key matrix, chunk widths) to
        host. fetch (TopK) truncates each run."""
        if getattr(self, "_host_sort", False):
            return self._sorted_run_host(acc)
        return self._sorted_run_device(acc)

    def _sorted_run_host(self, acc: list) -> tuple:
        """Host run sort: identical key encoding to sort_key_columns,
        np.lexsort + one Arrow take."""
        import pyarrow as pa

        tab = pa.Table.from_batches([b.to_arrow() for b in acc])
        cols, chunks = _host_key_columns(tab, self.keys,
                                         getattr(self, "_chunks_seen", None))
        self._chunks_seen = chunks
        order = np.lexsort(tuple(reversed(cols))) if cols else \
            np.arange(tab.num_rows)
        n = len(order)
        if self.fetch is not None:
            n = min(n, self.fetch)
            order = order[:n]
        tab = tab.take(pa.array(order))
        keys = np.stack([c[order] for c in cols], axis=1) if cols else \
            np.zeros((n, 0), np.int64)
        return tab, keys, chunks

    def _sorted_run_device(self, acc: list) -> tuple:
        combined = concat_batches(self.schema(), acc)
        # size var-width keys: 8-byte chunks for an EXACT lexicographic
        # sort (one cheap eager eval + scalar sync, per run)
        from .expressions import NullsOrder

        specs = []
        for e, asc in self.keys:
            ee = e.child if isinstance(e, NullsOrder) else e
            v = eval_expr(ee, combined)
            nchunks = 0
            if isinstance(v, (VarColumn, DictColumn)):
                if isinstance(v, DictColumn):
                    v = layout_ops.dict_to_var(v)
                maxlen = int(jax.device_get(
                    jnp.max(jnp.where(combined.row_mask(),
                                      layout_ops.row_lengths(v.offsets), 0),
                            initial=0)))
                nchunks = max(1, (maxlen + 7) // 8)
            specs.append((e, asc, nchunks))
        # widen remembered chunk sizes so later runs agree (merge pads the
        # narrower run's key matrix with the zero-chunk constant)
        prev = getattr(self, "_specs_seen", None)
        if prev is not None:
            specs = [(e, a, max(nc, p[2]))
                     for (e, a, nc), p in zip(specs, prev)]
        self._specs_seen = specs
        step = _jit_sort_run(tuple(specs))
        out, keys = step(combined)
        n = out.num_rows_host()
        if self.fetch is not None:
            n = min(n, self.fetch)
        tab = out.to_arrow()
        import pyarrow as pa

        tab = pa.Table.from_batches([tab]).slice(0, n)
        key_np = np.asarray(jax.device_get(keys))[:n]
        return tab, key_np, [nc for _e, _a, nc in specs]


_I64_SIGN = np.int64(-(1 << 63))  # the 1<<63 bit pattern in two's complement


def _host_key_columns(tab, keys: list, prev_chunks: Optional[list]):
    """Numpy key columns for a host run sort — bit-identical encoding to
    the device sort_key_columns (minus the padding column: host rows are
    all live), so host-sorted and device-sorted runs merge interchangeably.

    Returns (cols list[int64 np array], chunk widths per key)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from .expressions import NullsOrder

    cols: list = []
    chunks: list = []
    for j, (e, asc) in enumerate(keys):
        nulls_first = None
        if isinstance(e, NullsOrder):
            nulls_first, e = e.first, e.child

        def vcol(null):
            if nulls_first is None:
                vk = null.astype(np.int64)
                return vk if asc else np.int64(-1) - vk
            return (~null).astype(np.int64) if nulls_first \
                else null.astype(np.int64)

        arr = tab.column(e.name)
        arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
        t = arr.type
        if pa.types.is_dictionary(t):
            arr = arr.cast(pa.utf8())
            t = arr.type
        if pa.types.is_string(t) or pa.types.is_large_string(t) \
                or pa.types.is_binary(t):
            if not pa.types.is_string(t):
                arr = arr.cast(pa.utf8())
            null = np.asarray(arr.is_null())
            bufs = arr.buffers()
            offs = np.frombuffer(bufs[1], np.int32, len(arr) + 1,
                                 arr.offset * 4).astype(np.int64)
            vals = (np.frombuffer(bufs[2], np.uint8)
                    if bufs[2] is not None else np.zeros(0, np.uint8))
            lens = offs[1:] - offs[:-1]
            lens = np.where(null, 0, lens)
            maxlen = int(lens.max()) if len(lens) else 0
            nc = max(1, (maxlen + 7) // 8)
            if prev_chunks is not None:
                nc = max(nc, prev_chunks[j])
            cols.append(vcol(null))
            n = len(lens)
            starts = offs[:-1]
            idx = starts[:, None] + np.arange(8 * nc, dtype=np.int64)
            limit = (starts + lens)[:, None]
            src = vals[np.minimum(idx, max(len(vals) - 1, 0))] \
                if len(vals) else np.zeros_like(idx, np.uint8)
            pre = np.where(idx < limit, src, 0).astype(np.uint64)
            for c in range(nc):
                k = np.zeros(n, np.uint64)
                for t8 in range(8 * c, 8 * c + 8):
                    k = (k << np.uint64(8)) | pre[:, t8]
                k = (k.view(np.int64)) ^ _I64_SIGN
                cols.append(k if asc else np.int64(-1) - k)
            chunks.append(nc)
        else:
            null = np.asarray(arr.is_null())
            if null.any():
                fill = pa.scalar(False, type=t) if pa.types.is_boolean(t) \
                    else pa.scalar(0, type=t)
                arr = pc.fill_null(arr, fill)
            vals = arr.to_numpy(zero_copy_only=False)
            if vals.dtype.kind == "f":
                f = np.ascontiguousarray(vals.astype(np.float64))
                bits = f.view(np.int64)
                flipped = np.where(bits < 0, ~bits, bits | _I64_SIGN)
                k = flipped ^ _I64_SIGN
            else:
                k = vals.astype(np.int64)
            # validity as its own (more significant) column — a sentinel
            # value cannot be safe for float bitcast keys
            cols.append(vcol(null))
            cols.append(k if asc else np.int64(-1) - k)
            chunks.append(0)
    return cols, chunks


def _key_bytes(key_cols: np.ndarray) -> np.ndarray:
    """[n, C] int64 key matrix → 'S(8C)' byte strings whose bytewise order
    equals the column-lexicographic int64 order."""
    n, c = key_cols.shape
    u = (key_cols ^ np.int64(-(1 << 63))).view(np.uint64)
    be = np.ascontiguousarray(u.astype(">u8"))
    return be.view(f"S{8 * c}").reshape(n)


def _pad_key_matrix(keys: np.ndarray, chunks: list, target: list,
                    specs_asc: list) -> np.ndarray:
    """Insert zero-chunk constant columns so a narrower run's key matrix
    matches the widest run's layout. Layout per key: (validity + chunks)
    for var-width keys, else one column."""
    if chunks == target:
        return keys
    cols = []
    pos = 0
    for (nc, tnc), asc in zip(zip(chunks, target), specs_asc):
        if nc == 0:
            cols.append(keys[:, pos:pos + 2])  # validity + value
            pos += 2
            continue
        cols.append(keys[:, pos:pos + 1 + nc])  # validity + real chunks
        pos += 1 + nc
        if tnc > nc:
            const = np.int64(-(1 << 63))
            if not asc:
                const = np.int64(-1) - const
            cols.append(np.full((keys.shape[0], tnc - nc), const, np.int64))
    return np.concatenate(cols, axis=1)


def _merge_runs(runs: list, asc_flags: list) -> tuple:
    """Pairwise stable merge of sorted (table, key-matrix, chunk-widths)
    runs; earlier runs win ties (global stability). Returns the merged
    run tuple."""
    items = list(runs)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(_merge_two(items[i], items[i + 1], asc_flags))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _merge_two(a: tuple, b: tuple, asc_flags: list) -> tuple:
    import pyarrow as pa

    ta, ka, ca = a
    tb, kb, cb = b
    target = [max(x, y) for x, y in zip(ca, cb)]
    ka = _pad_key_matrix(ka, ca, target, asc_flags)
    kb = _pad_key_matrix(kb, cb, target, asc_flags)
    sa, sb = _key_bytes(ka), _key_bytes(kb)
    na, nb = len(sa), len(sb)
    pos_a = np.arange(na, dtype=np.int64) + np.searchsorted(sb, sa,
                                                            side="left")
    pos_b = np.arange(nb, dtype=np.int64) + np.searchsorted(sa, sb,
                                                            side="right")
    take = np.empty(na + nb, np.int64)
    take[pos_a] = np.arange(na, dtype=np.int64)
    take[pos_b] = na + np.arange(nb, dtype=np.int64)
    tab = pa.concat_tables([ta, tb]).take(pa.array(take))
    keys = np.empty((na + nb, ka.shape[1]), np.int64)
    keys[pos_a] = ka
    keys[pos_b] = kb
    return tab, keys, target


def _emit_table(tab, schema: Schema) -> Iterator[Batch]:
    """Stream an Arrow table out as bounded HOST batches.

    Downstream operators jit-transfer what they compute on; root collects
    read the numpy buffers directly, with no copy through the device."""
    import os as _os

    chunk = int(_os.environ.get("EXON_TPU_SORT_EMIT_ROWS", 1 << 16))
    n = tab.num_rows
    if n == 0:
        yield _empty_batch(schema)
        return
    combined = tab.combine_chunks()
    for lo in range(0, n, chunk):
        piece = combined.slice(lo, min(chunk, n - lo))
        rbs = piece.to_batches()
        if len(rbs) == 1:
            yield Batch.from_arrow(rbs[0], schema)
        else:
            import pyarrow as pa

            yield Batch.from_arrow(
                pa.Table.from_batches(rbs).combine_chunks().to_batches()[0],
                schema)


@functools.cache
def _jit_sort_step(specs: tuple):
    @jax.jit
    def step(batch: Batch) -> Batch:
        perm = sort_permutation(batch, specs)
        return layout_ops.take_batch(batch, perm, jnp.asarray(batch.length, jnp.int32))

    return step


@functools.cache
def _jit_sort_run(specs: tuple):
    """Sort a run AND return its sorted key matrix (for the external
    merge) in one device program."""

    @jax.jit
    def step(batch: Batch):
        cols = sort_key_columns(batch, specs)
        perm = jnp.arange(batch.capacity, dtype=jnp.int32)
        for k in reversed(cols):
            perm = perm[jnp.argsort(k[perm], stable=True)]
        out = layout_ops.take_batch(batch, perm,
                                    jnp.asarray(batch.length, jnp.int32))
        keys = jnp.stack([k[perm] for k in cols[1:]], axis=1)
        return out, keys

    return step


def sort_key_columns(batch: Batch, specs: tuple) -> list:
    """int64 key columns, MOST significant first, whose column-lexicographic
    order is the sort order: leading ~row_mask pushes padding last; each
    spec contributes its asc/desc- and null-adjusted key (var-width keys as
    a validity column + big-endian 8-byte chunks). Shared by the in-device
    permutation sort and the external run merge, so both orders agree
    exactly."""
    from .expressions import NullsOrder

    cols = [jnp.logical_not(batch.row_mask()).astype(jnp.int64)]
    for e, asc, nchunks in specs:
        nulls_first = None
        if isinstance(e, NullsOrder):
            nulls_first, e = e.first, e.child
        v = eval_expr(e, batch)
        if isinstance(v, DictColumn) and nchunks > 0:
            # cross-run merges need run-independent keys: dictionary codes
            # rank within one run's vocab only, so spill to bytes
            v = layout_ops.dict_to_var(v)
        def validity_col(valid):
            # default placement: ASC → nulls last, DESC → nulls first;
            # NULLS FIRST/LAST overrides directly
            if nulls_first is None:
                vk = jnp.logical_not(valid).astype(jnp.int64)
                return vk if asc else _invert_key(vk)
            vk = (jnp.asarray(valid).astype(jnp.int64) if nulls_first
                  else jnp.logical_not(valid).astype(jnp.int64))
            # bypass the asc inversion: the placement is already final
            return vk

        if isinstance(v, VarColumn) and nchunks > 0:
            cols.append(validity_col(v.validity))
            pre, _m = layout_ops.gather_prefix(v, 8 * nchunks)
            for c in range(nchunks):
                k = jnp.zeros(v.capacity, jnp.int64)
                for t in range(8 * c, 8 * c + 8):
                    k = (k << 8) | pre[:, t].astype(jnp.int64)
                # unsigned byte order under signed int64 compare
                k = k ^ (jnp.int64(1) << 63)
                cols.append(k if asc else _invert_key(k))
        else:
            # fixed-width: validity gets its OWN column. Embedding a null
            # sentinel in the value key is unsound for floats — the bitcast
            # of any double >= 2.0 exceeds 2^62, so sentinel-nulls would
            # sort between real values
            k, valid = _sort_key_value_raw(v, batch)
            cols.append(validity_col(valid))
            cols.append(k if asc else _invert_key(k))
    return cols


def sort_permutation(batch: Batch, specs: tuple) -> jnp.ndarray:
    """Stable multi-key sort permutation (last key least significant).

    Each spec is (expr, ascending, nchunks) where nchunks > 0 marks a
    var-width key sorted EXACTLY via iterated stable sorts over 8-byte
    chunks, least-significant chunk first (LSD radix over 64-bit digits);
    nulls follow DataFusion defaults (ASC → last, DESC → first).
    """
    if specs and len(specs[0]) == 2:  # tolerate legacy (expr, asc) specs
        specs = tuple((e, asc, 0) for e, asc in specs)
    cols = sort_key_columns(batch, specs)
    perm = jnp.arange(batch.capacity, dtype=jnp.int32)
    for k in reversed(cols):
        perm = perm[jnp.argsort(k[perm], stable=True)]
    return perm


def _sort_key_value_raw(v, batch: Batch):
    """(order key int64, validity) withOUT a null sentinel embedded — the
    exact sort paths carry validity as its own key column."""
    if isinstance(v, DictColumn):
        vocab_rank = np.argsort(np.argsort(list(v.vocab))) if v.vocab \
            else np.zeros(0)
        k = jnp.asarray(vocab_rank, jnp.int64)[
            jnp.clip(v.codes, 0, max(len(v.vocab) - 1, 0))]
        return k, jnp.asarray(v.validity)
    if isinstance(v, FixedColumn):
        return _to_sortable_i64(v.values), jnp.asarray(v.validity)
    if isinstance(v, VarColumn):
        # 8-byte prefix key (callers needing exact var ordering use the
        # chunked path); validity separate
        pre, _m = layout_ops.gather_prefix(v, 8)
        key = jnp.zeros(v.capacity, jnp.int64)
        for t in range(8):
            key = (key << 8) | pre[:, t].astype(jnp.int64)
        return key ^ (jnp.int64(1) << 63), jnp.asarray(v.validity)
    arr = jnp.asarray(v)
    return _to_sortable_i64(arr), jnp.ones(arr.shape[0], bool)


def _sort_key_values(v, batch: Batch) -> jnp.ndarray:
    if isinstance(v, DictColumn):
        # order by vocab string order
        vocab_rank = np.argsort(np.argsort(list(v.vocab))) if v.vocab else np.zeros(0)
        return jnp.asarray(vocab_rank, jnp.int64)[
            jnp.clip(v.codes, 0, max(len(v.vocab) - 1, 0))]
    if isinstance(v, VarColumn):
        # single-chunk approximation; exact path is the nchunks>0 branch in
        # sort_permutation (callers outside SortExec size their own chunks)
        pre, _m = layout_ops.gather_prefix(v, 8)
        key = jnp.zeros(v.capacity, jnp.int64)
        for t in range(8):
            key = (key << 8) | pre[:, t].astype(jnp.int64)
        return key ^ (jnp.int64(1) << 63)
    if isinstance(v, FixedColumn):
        vals = v.values
        nulls = jnp.logical_not(v.validity)
        k = _to_sortable_i64(vals)
        big = jnp.int64(2 ** 62)
        return jnp.where(nulls, big, k)  # nulls last
    return _to_sortable_i64(jnp.asarray(v))


def _to_sortable_i64(vals: jnp.ndarray) -> jnp.ndarray:
    if jnp.issubdtype(vals.dtype, jnp.floating):
        f = vals.astype(jnp.float64)
        bits = jax.lax.bitcast_convert_type(f, jnp.int64)
        # IEEE754 → order-preserving signed int: negatives flip all bits,
        # positives flip the sign bit
        flipped = jnp.where(bits < 0, ~bits, bits | (jnp.int64(1) << 63))
        return flipped ^ (jnp.int64(1) << 63)
    if vals.dtype == jnp.bool_:
        return vals.astype(jnp.int64)
    return vals.astype(jnp.int64)


def _invert_key(k: jnp.ndarray) -> jnp.ndarray:
    return jnp.int64(-1) - k


@functools.cache
def _jit_limit_slice(capacity: int):
    @jax.jit
    def step(batch: Batch, skip, fetch) -> Batch:
        idx = jnp.arange(capacity, dtype=jnp.int32) + skip
        n = jnp.asarray(batch.length, jnp.int32)
        count = jnp.clip(n - skip, 0, fetch)
        return layout_ops.take_batch(batch, idx, count)

    return step


@dataclasses.dataclass
class LimitExec(PhysicalPlan):
    skip: int
    fetch: Optional[int]
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        remaining_skip = self.skip
        remaining_fetch = self.fetch if self.fetch is not None else None
        for b in self.input.batches():
            n = b.num_rows_host()
            if remaining_skip >= n:
                remaining_skip -= n
                continue
            take = n - remaining_skip
            if remaining_fetch is not None:
                take = min(take, remaining_fetch)
            if take <= 0:
                return
            out = _jit_limit_slice(b.capacity)(b, jnp.int32(remaining_skip),
                                               jnp.int32(take))
            remaining_skip = 0
            if remaining_fetch is not None:
                remaining_fetch -= take
            yield out
            if remaining_fetch is not None and remaining_fetch <= 0:
                return


@dataclasses.dataclass
class UnionExec(PhysicalPlan):
    inputs: list[PhysicalPlan]

    def children(self):
        return list(self.inputs)

    def schema(self) -> Schema:
        return self.inputs[0].schema()

    def batches(self) -> Iterator[Batch]:
        # union is positional: rebind every child batch to the first
        # input's field names (DataFusion UNION ALL semantics)
        schema = self.schema()
        for p in self.inputs:
            for b in p.batches():
                yield Batch(schema, b.columns, b.length)


@dataclasses.dataclass
class ValuesExec(PhysicalPlan):
    out_schema: Schema
    rows: list

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        import pyarrow as pa

        from ..batch import arrow_type

        cols = list(zip(*self.rows)) if self.rows else [[] for _ in self.out_schema.all_fields]
        arrays = [pa.array(list(c), type=arrow_type(f.dtype))
                  for c, f in zip(cols, self.out_schema.all_fields)]
        rb = pa.RecordBatch.from_arrays(arrays, names=self.out_schema.names)
        yield Batch.from_arrow(rb, self.out_schema).to_device()
