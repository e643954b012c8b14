"""Distributed query execution over a device mesh.

This wires the shuffle substrate (parallel/shuffle.py) into the engine: a
``DistributedAggregateExec`` physical operator that executes the whole
scan→filter→project→aggregate pipeline data-parallel over the ``shard``
axis of a ``jax.sharding.Mesh``, replacing the role DataFusion's
repartitioned hash aggregate plays in the reference engine
(exon-core/src/config/mod.rs:31,40-43 enables repartitioned aggregates;
RepartitionExec hash-partitions batches between pipeline stages).

Execution model (SPMD):

  * The host decode stream is dealt round-robin into *waves* of ``n_dev``
    fixed-capacity batches. A wave is stacked leaf-wise into one pytree with
    a leading device axis and placed with ``NamedSharding(mesh, P('shard'))``
    — one batch per device, a single host→device transfer per wave.
  * One jitted ``shard_map`` step per wave runs the fused per-batch pipeline
    (filter masks, projections, group-key hashing, segment reductions) on
    every device and folds the result into a per-device fixed-capacity
    group state (sorted key hashes + partial accumulators + fixed-width
    representative key values). No collectives, no host syncs in the loop
    beyond one overflow-flag scalar per wave.
  * A final jitted ``shard_map`` step hash-partitions the per-device group
    partials with ``lax.all_to_all`` (hash_partition_shuffle) so each device
    owns a disjoint key range, merges its range locally, and returns the
    sharded merged tables; the host concatenates the disjoint ranges and
    emits the output batch in first-seen order (same emission order as the
    single-device path, so results are bit-identical).

Group keys travel as 64-bit content hashes plus a fixed-width (``rep_w``)
byte prefix of a representative value; keys longer than ``rep_w`` raise and
the caller falls back to single-device execution (group keys are contig /
feature names in practice — cheap insurance, never silent corruption).

Operator coverage note: aggregates (incl. the DISTINCT dedup stage),
windows (PARTITION BY sharding), broadcast + partitioned joins, and TopK
route to the mesh. Full ORDER BY deliberately does NOT: the external run
sort (plan/physical.py SortExec) already bounds memory and parallelizes
ingest, and merges its runs with a host searchsorted ladder instead of
shipping them between devices. TopK — the common large-ORDER-BY shape —
is mesh-routed via plan_distributed_topk.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch import (Batch, DictColumn, FixedColumn, PrefixColumn, Schema,
                     VarColumn, bucket_capacity)
from ..errors import ExecutionError, PlanError
from ..ops import aggregate as agg_ops
from ..ops import layout as layout_ops
from ..plan.expressions import (AggregateCall, Expr, as_bool_mask,
                                contains_host_fn, eval_expr)
from ..plan.physical import (PhysicalPlan, _empty_batch, _group_key_i64,
                             _merge_partial, _partial_for, _to_column)
from .mesh import make_mesh
from .shuffle import hash_partition_shuffle

_I64MAX = jnp.iinfo(jnp.int64).max
DEFAULT_REP_W = 64          # max group-key bytes carried through the exchange
DEFAULT_STATE_CAP = 1 << 16  # per-device live-group capacity


class RepTooLongError(ExecutionError):
    """A group-key value exceeded rep_w bytes — fall back to single-device."""


class StateOverflowError(ExecutionError):
    """Distinct groups per device exceeded state capacity."""


# ---------------------------------------------------------------------------
# Representative-value carriers (fixed-shape, exchangeable via all_to_all)
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FixedRep:
    values: Any    # [cap] primitive
    validity: Any  # bool [cap]

    def tree_flatten(self):
        return (self.values, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VarRep:
    prefix: Any    # uint8 [cap, rep_w]
    lens: Any      # int32 [cap]
    validity: Any  # bool [cap]

    def tree_flatten(self):
        return (self.prefix, self.lens, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistAggState:
    """Per-device group-by state (leading axis = shard when sharded)."""

    keys: Any       # int64 [cap] sorted; pad = I64MAX
    first: Any      # int64 [cap] global first-seen rank
    partials: tuple  # per agg call: arr[cap] or (arr[cap], arr[cap])
    reps: tuple     # per group expr: FixedRep | VarRep
    count: Any      # int32 scalar — live groups
    overflow: Any   # bool scalar — groups were dropped (state too small)
    too_long: Any   # bool scalar — a rep value exceeded rep_w

    def tree_flatten(self):
        return ((self.keys, self.first, self.partials, self.reps,
                 self.count, self.overflow, self.too_long), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# ---------------------------------------------------------------------------
# Host-side wave staging
# ---------------------------------------------------------------------------


def host_dict_to_var(col: DictColumn) -> VarColumn:
    """Decode dictionary codes to a flat utf8 column on the host (vocab is
    per-batch metadata, so stacking across batches requires flat values)."""
    enc = [s.encode() for s in col.vocab] or [b""]
    codes = np.asarray(col.codes)
    validity = np.asarray(col.validity)
    cap = codes.shape[0]
    safe = np.clip(codes, 0, len(enc) - 1)
    lens = np.asarray([len(e) for e in enc], np.int32)[safe]
    lens = np.where(validity, lens, 0)
    offsets = np.zeros(cap + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    vcap = bucket_capacity(max(total, 1))
    values = np.zeros(vcap, np.uint8)
    pos = 0
    for i in range(cap):
        if lens[i]:
            e = enc[safe[i]]
            values[pos:pos + len(e)] = np.frombuffer(e, np.uint8)
            pos += len(e)
    return VarColumn(values, offsets, validity)


def _pad_np(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape[0] == cap:
        return arr
    out = np.full((cap,) + arr.shape[1:], fill, arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def pad_host_batch(b: Batch, cap: int, vcaps: dict[int, int]) -> Batch:
    """Repad a host batch to a common wave shape (numpy, no copies when
    already at shape)."""
    cols = []
    for i, c in enumerate(b.columns):
        if isinstance(c, DictColumn):
            c = host_dict_to_var(c)
        if isinstance(c, FixedColumn):
            cols.append(FixedColumn(_pad_np(c.values, cap),
                                    _pad_np(c.validity, cap, False)))
        elif isinstance(c, VarColumn):
            off = np.asarray(c.offsets)
            noff = np.full(cap + 1, off[-1], np.int32)
            noff[:off.shape[0]] = off
            cols.append(VarColumn(_pad_np(c.values, vcaps[i]), noff,
                                  _pad_np(c.validity, cap, False)))
        elif isinstance(c, PrefixColumn):
            cols.append(PrefixColumn(_pad_np(c.prefix, cap),
                                     _pad_np(c.lengths, cap),
                                     _pad_np(c.validity, cap, False)))
        else:
            raise PlanError(f"distributed scan: unsupported column {type(c)}")
    return Batch(b.schema, cols, np.int32(b.length))


def wave_shape(batches: list[Batch]) -> tuple[int, dict[int, int]]:
    cap = max(b.capacity for b in batches)
    vcaps: dict[int, int] = {}
    for b in batches:
        for i, c in enumerate(b.columns):
            if isinstance(c, DictColumn):
                # post-conversion byte size: bounded by sum of code lengths
                enc_lens = np.asarray([len(s.encode()) for s in c.vocab] or [0])
                total = int(enc_lens[np.clip(np.asarray(c.codes), 0,
                                             max(len(c.vocab) - 1, 0))].sum()) \
                    if len(c.vocab) else 0
                v = bucket_capacity(max(total, 1))
            elif isinstance(c, VarColumn):
                v = c.value_capacity
            else:
                continue
            vcaps[i] = max(vcaps.get(i, 1), v)
    return cap, vcaps


def empty_like_host(b: Batch, cap: int, vcaps: dict[int, int]) -> Batch:
    """A zero-row host batch with the wave's schema and capacities."""
    cols = []
    for i, c in enumerate(b.columns):
        if isinstance(c, (FixedColumn,)):
            cols.append(FixedColumn(np.zeros((cap,) + np.asarray(c.values).shape[1:],
                                             np.asarray(c.values).dtype),
                                    np.zeros(cap, bool)))
        elif isinstance(c, (VarColumn, DictColumn)):
            vdt = np.uint8 if isinstance(c, DictColumn) else np.asarray(c.values).dtype
            cols.append(VarColumn(np.zeros(vcaps[i], vdt),
                                  np.zeros(cap + 1, np.int32),
                                  np.zeros(cap, bool)))
        elif isinstance(c, PrefixColumn):
            cols.append(PrefixColumn(
                np.zeros((cap, np.asarray(c.prefix).shape[1]), np.uint8),
                np.zeros(cap, np.int32), np.zeros(cap, bool)))
        else:
            raise PlanError(f"distributed scan: unsupported column {type(c)}")
    return Batch(b.schema, cols, np.int32(0))


def stack_wave(batches: list[Batch], mesh: Mesh) -> Batch:
    """Stack host batches leaf-wise and place sharded over 'shard'.

    Single-process: ``batches`` covers the whole shard axis. Multi-host:
    each process passes only its LOCAL batches (one per addressable shard
    row) and the global array assembles from per-process shards without any
    cross-host data movement (``make_array_from_process_local_data``)."""
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                           *batches)
    sharding = NamedSharding(mesh, P("shard"))
    if jax.process_count() > 1:
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(sharding, x),
            stacked)
    return jax.device_put(stacked, sharding)


def pad_wave(wave: list, n_slots: int):
    """Pad to n_slots batches with wave-shape caps synchronized across
    processes (jit steps must see identical shapes everywhere).

    Multi-host waves are guaranteed non-empty by lockstep_wave_iter (a
    drained process yields a zero-row template batch), so the column count
    of the shape vector is schema-determined and identical on every
    process. An empty wave here is a caller bug — raise BEFORE entering
    the collective so the failure is loud rather than a shape-mismatched
    allgather."""
    if not wave:
        raise ExecutionError(
            "pad_wave on an empty wave: multi-host waves must come from "
            "lockstep_wave_iter, which pads drained processes with a "
            "zero-row template batch")
    cap, vcaps = wave_shape(wave)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        ncols = len(wave[0].columns)
        vec = np.zeros(ncols + 1, np.int64)
        vec[0] = cap
        for i, v in vcaps.items():
            if i + 1 <= ncols:
                vec[i + 1] = v
        allv = multihost_utils.process_allgather(vec)
        vec = np.max(np.asarray(allv).reshape(-1, ncols + 1), axis=0)
        cap = int(vec[0])
        vcaps = {i: int(vec[i + 1]) for i in range(ncols)
                 if vec[i + 1] > 0}
    while len(wave) < n_slots:
        wave.append(empty_like_host(wave[0], cap, vcaps))
    return wave, cap, vcaps


def _zero_row_template(b: Batch) -> Batch:
    """A minimal zero-row host batch with b's schema and column kinds."""
    vcaps = {i: 1 for i, c in enumerate(b.columns)
             if isinstance(c, (VarColumn, DictColumn))}
    return empty_like_host(b, 1, vcaps)


def allgather_pickled(obj) -> list:
    """Exchange one picklable host object per process; returns the list of
    every process's object in process order (identical on all processes).

    The cross-process host data plane for operators whose final result
    must replicate (window payload tables, sorted runs, join sides): one
    padded byte allgather across processes — sizes first, then the max-padded
    buffers."""
    import pickle

    from jax.experimental import multihost_utils

    buf = np.frombuffer(pickle.dumps(obj), np.uint8)
    sizes = np.asarray(multihost_utils.process_allgather(
        np.asarray([buf.size], np.int64))).reshape(-1)
    m = int(np.max(sizes))
    pad = np.zeros(max(m, 1), np.uint8)
    pad[:buf.size] = buf
    allb = np.asarray(multihost_utils.process_allgather(pad))
    allb = allb.reshape(-1, max(m, 1))
    return [pickle.loads(allb[p, :int(sizes[p])].tobytes())
            for p in range(len(sizes))]


def _sync_template(tpl):
    """Collectively agree on a zero-row template batch across processes.

    Every process calls this (it is an allgather); processes that have
    seen a local batch pass its template, drained/file-less processes pass
    None and reconstruct one from a peer's pickled bytes. Keeps uneven
    per-process batch counts (3 files over 2 processes, or a process with
    zero files) from crashing the lockstep wave loop."""
    objs = allgather_pickled(tpl)
    if tpl is not None:
        return tpl
    for o in objs:
        if o is not None:
            return o
    raise ExecutionError(
        "no process produced a batch to derive the wave schema")


def local_row_indices(mesh: Mesh) -> list[int]:
    """Global shard-axis rows whose devices this process addresses, in
    mesh order (the rows this process must feed to stack_wave)."""
    if jax.process_count() <= 1:
        return list(range(mesh.shape["shard"]))
    pid = jax.process_index()
    return [i for i, row in enumerate(mesh.devices)
            if all(d.process_index == pid for d in np.atleast_1d(row))]


def put_sharded_rows(arrs, mesh: Mesh):
    """Place host arrays with leading dim n_dev sharded over 'shard'.
    Single-process: device_put. Multi-host: every process holds the full
    (identical) host value and contributes only its local rows."""
    sharding = NamedSharding(mesh, P("shard"))
    if jax.process_count() <= 1:
        return jax.tree.map(lambda x: jax.device_put(x, sharding), arrs)
    rows = local_row_indices(mesh)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(np.asarray(x)[rows])), arrs)


def _multihost_shardable(node) -> bool:
    """Multi-host distributed execution requires the scan's provider to
    shard its file list per process (iter_scan_files); a non-sharding
    provider would contribute its FULL rows from every process."""
    return jax.process_count() <= 1 or \
        getattr(node.provider, "shards_files", False)


def _scan_chain(node) -> bool:
    """True if the logical subtree is row-wise ops over one FILE-SHARDED
    Scan — the shape whose multi-host execution shards ingest cleanly
    (each process decodes files[p::P] and the shards are disjoint row
    sets). Providers that don't route through iter_scan_files (MemTable,
    Delta) would contribute their FULL rows from every process and
    duplicate results, so they must not pass this gate."""
    from ..plan import logical as L

    while isinstance(node, (L.Filter, L.Project)):
        node = node.input
    return isinstance(node, L.Scan) and \
        getattr(node.provider, "shards_files", False)  # see _multihost_shardable


def lockstep_wave_iter(source: Callable[[], Iterator[Batch]], mesh: Mesh):
    """Yield lists of this process's local batches, one wave at a time,
    until EVERY process's stream drains. Multi-host: the source runs under
    the scan-shard context (each host decodes only its file shard) and a
    tiny per-wave allgather keeps the SPMD step count identical across
    processes (stragglers feed empty waves)."""
    import contextlib
    import itertools

    from .mesh import local_shard_count, scan_shard_context

    n_dev = mesh.shape["shard"]
    multi = jax.process_count() > 1
    n_local = local_shard_count(mesh) if multi else n_dev
    ctx = scan_shard_context(jax.process_index(), jax.process_count()) \
        if multi else contextlib.nullcontext()
    with ctx:
        it = iter(source())
        tpl = None
        synced = False
        while True:
            wave = list(itertools.islice(it, n_local))
            have = len(wave) > 0
            if multi:
                from jax.experimental import multihost_utils

                total = np.asarray(multihost_utils.process_allgather(
                    np.asarray([1 if have else 0], np.int32)))
                if int(np.sum(total)) == 0:
                    return
                if have and tpl is None:
                    tpl = _zero_row_template(wave[0])
                # some process drained (or never had files): collectively
                # agree on a zero-row template once, then pad empty local
                # waves with it so every process takes the same SPMD steps
                if int(np.min(total)) == 0 and not synced:
                    tpl = _sync_template(tpl)
                    synced = True
                if not have:
                    wave = [tpl]
            elif not have:
                return
            yield wave


def replicate_to_mesh(tree, mesh: Mesh):
    """Place a host pytree replicated over every device of the mesh.
    Multi-host: each process supplies its identical local copy
    (deterministic recomputation) via make_array_from_process_local_data."""
    repl = NamedSharding(mesh, P())
    if jax.process_count() > 1:
        host = jax.device_get(tree)
        return jax.tree.map(
            lambda x: jax.make_array_from_process_local_data(
                repl, np.asarray(x)), host)
    return jax.device_put(tree, repl)


def gather_full(tree, mesh: Mesh):
    """Fetch a shard-sharded pytree to host numpy with the FULL global
    value. Single-process: plain device_get. Multi-host: a jitted identity
    with replicated out_shardings all-gathers across hosts first, so every
    process can read the complete result locally."""
    if jax.process_count() <= 1:
        return jax.device_get(tree)
    rep = NamedSharding(mesh, P())
    out = jax.jit(lambda t: t, out_shardings=rep)(tree)
    return jax.device_get(out)


def _squeeze0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _expand0(tree):
    return jax.tree.map(lambda x: x[None], tree)


# ---------------------------------------------------------------------------
# Per-device pipeline + group-state algebra (runs inside shard_map)
# ---------------------------------------------------------------------------


def apply_stages(stages: tuple, batch: Batch) -> tuple[Batch, jnp.ndarray]:
    """Run the fused per-batch pipeline; filters accumulate into a mask
    (no compaction — the aggregate consumes the mask directly)."""
    mask = batch.row_mask()
    for kind, payload, out_schema in stages:
        if kind == "filter":
            mask = jnp.logical_and(
                mask, as_bool_mask(eval_expr(payload, batch), batch))
        elif kind == "project":
            cols = [_to_column(eval_expr(e, batch), batch) for e in payload]
            batch = Batch(out_schema, cols, batch.length)
        else:
            raise PlanError(kind)
    return batch, mask


def _build_reps(group_exprs: tuple, batch: Batch, mask, first_idx,
                num_groups, rep_w: int) -> tuple[tuple, jnp.ndarray]:
    """Representative key values per group slot, fixed-width."""
    cap = batch.capacity
    slot_live = jnp.arange(first_idx.shape[0], dtype=jnp.int32) < num_groups
    idx = jnp.clip(first_idx, 0, cap - 1)
    reps = []
    too_long = jnp.asarray(False)
    for e in group_exprs:
        v = eval_expr(e, batch)
        if isinstance(v, DictColumn):
            v = layout_ops.dict_to_var(v)
        if isinstance(v, VarColumn):
            lens = layout_ops.row_lengths(v.offsets)
            too_long = jnp.logical_or(
                too_long, jnp.any(jnp.logical_and(mask, lens > rep_w)))
            pre, _ = layout_ops.gather_prefix(v, rep_w)
            reps.append(VarRep(jnp.where(slot_live[:, None], pre[idx], 0),
                               jnp.where(slot_live, lens[idx], 0),
                               jnp.where(slot_live, v.validity[idx], False)))
        elif isinstance(v, FixedColumn):
            reps.append(FixedRep(jnp.where(slot_live, v.values[idx], 0),
                                 jnp.where(slot_live, v.validity[idx], False)))
        else:
            arr = jnp.asarray(v)
            reps.append(FixedRep(jnp.where(slot_live, arr[idx], 0), slot_live))
    return tuple(reps), too_long


def batch_group_state(group_exprs: tuple, agg_calls: tuple, batch: Batch,
                      mask, base_rank, rep_w: int) -> DistAggState:
    """One batch → a DistAggState sized at the batch capacity."""
    cap = batch.capacity
    keys = _group_key_i64(group_exprs, batch)
    gids, gkeys, ng = agg_ops.sort_group_ids(keys, mask)
    first_idx = jnp.full(cap, cap, jnp.int32).at[
        jnp.where(mask, gids, cap - 1)
    ].min(jnp.where(mask, jnp.arange(cap, dtype=jnp.int32), cap))
    slot = jnp.arange(cap, dtype=jnp.int32)
    first = jnp.where(slot < ng, base_rank + first_idx.astype(jnp.int64),
                      _I64MAX)
    partials = tuple(_partial_for(call, batch, mask, gids, cap)
                     for call in agg_calls)
    reps, too_long = _build_reps(group_exprs, batch, mask, first_idx, ng, rep_w)
    return DistAggState(gkeys, first, partials, reps, ng,
                        jnp.asarray(False), too_long)


def _take_rep(rep, idx, slot_live):
    if isinstance(rep, VarRep):
        return VarRep(jnp.where(slot_live[:, None], rep.prefix[idx], 0),
                      jnp.where(slot_live, rep.lens[idx], 0),
                      jnp.where(slot_live, rep.validity[idx], False))
    return FixedRep(jnp.where(slot_live, rep.values[idx], 0),
                    jnp.where(slot_live, rep.validity[idx], False))


def _concat_reps(reps_list: list) -> tuple:
    out = []
    for parts in zip(*reps_list):
        if isinstance(parts[0], VarRep):
            out.append(VarRep(jnp.concatenate([p.prefix for p in parts]),
                              jnp.concatenate([p.lens for p in parts]),
                              jnp.concatenate([p.validity for p in parts])))
        else:
            out.append(FixedRep(jnp.concatenate([p.values for p in parts]),
                                jnp.concatenate([p.validity for p in parts])))
    return tuple(out)


def merge_states(states: list[DistAggState], agg_calls: tuple,
                 out_cap: int) -> DistAggState:
    """Merge group states by key hash; result truncated to out_cap slots
    (overflow flagged, never silent)."""
    caps = [s.keys.shape[0] for s in states]
    cap = sum(caps)
    keys = jnp.concatenate([s.keys for s in states])
    first = jnp.concatenate([s.first for s in states])
    mask = jnp.concatenate([jnp.arange(c, dtype=jnp.int32) < s.count
                            for c, s in zip(caps, states)])
    gids, gkeys, ng = agg_ops.sort_group_ids(keys, mask)
    merged_partials = []
    for j, call in enumerate(agg_calls):
        comps = [s.partials[j] for s in states]
        if isinstance(comps[0], tuple):
            cat = tuple(jnp.concatenate([c[i] for c in comps])
                        for i in range(len(comps[0])))
        else:
            cat = jnp.concatenate(comps)
        merged_partials.append(_merge_partial(call, gids, mask, cat, cap))
    first_m = jnp.full(cap, _I64MAX, jnp.int64).at[
        jnp.clip(gids, 0, cap - 1)].min(jnp.where(mask, first, _I64MAX))
    packed = jnp.where(mask, first * cap + jnp.arange(cap, dtype=jnp.int64),
                       _I64MAX)
    best = jnp.full(cap, _I64MAX, jnp.int64).at[
        jnp.clip(gids, 0, cap - 1)].min(packed)
    rep_idx = jnp.clip(best % cap, 0, cap - 1).astype(jnp.int32)
    slot_live = jnp.arange(cap, dtype=jnp.int32) < ng
    reps_cat = _concat_reps([s.reps for s in states])
    reps = tuple(_take_rep(r, rep_idx, slot_live) for r in reps_cat)
    overflow = functools.reduce(jnp.logical_or,
                                [s.overflow for s in states], ng > out_cap)
    too_long = functools.reduce(jnp.logical_or,
                                [s.too_long for s in states],
                                jnp.asarray(False))

    def fit(x, fill):
        if x.shape[0] == out_cap:
            return x
        if x.shape[0] > out_cap:
            return x[:out_cap]
        pad = jnp.full((out_cap - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, pad])

    partials = tuple(tuple(fit(c, 0) for c in p) if isinstance(p, tuple)
                     else fit(p, 0) for p in merged_partials)
    reps = tuple(
        VarRep(fit(r.prefix, 0), fit(r.lens, 0), fit(r.validity, False))
        if isinstance(r, VarRep)
        else FixedRep(fit(r.values, 0), fit(r.validity, False))
        for r in reps)
    return DistAggState(fit(gkeys, _I64MAX), fit(first_m, _I64MAX), partials,
                        reps, jnp.minimum(ng, out_cap), overflow, too_long)


def _flat_state_cols(state: DistAggState) -> tuple[list, Callable]:
    """Flatten partials + reps into a flat column list for the shuffle, plus
    a rebuilder closure."""
    cols: list = [state.first]
    spec = []
    for p in state.partials:
        if isinstance(p, tuple):
            spec.append(len(p))
            cols.extend(p)
        else:
            spec.append(0)
            cols.append(p)
    rep_spec = []
    for r in state.reps:
        if isinstance(r, VarRep):
            rep_spec.append("var")
            cols.extend([r.prefix, r.lens, r.validity])
        else:
            rep_spec.append("fixed")
            cols.extend([r.values, r.validity])

    def rebuild(flat: list) -> tuple[Any, tuple, tuple]:
        it = iter(flat)
        first = next(it)
        partials = []
        for s in spec:
            if s == 0:
                partials.append(next(it))
            else:
                partials.append(tuple(next(it) for _ in range(s)))
        reps = []
        for rs in rep_spec:
            if rs == "var":
                reps.append(VarRep(next(it), next(it), next(it)))
            else:
                reps.append(FixedRep(next(it), next(it)))
        return first, tuple(partials), tuple(reps)

    return cols, rebuild


def exchange_and_merge(axis_name: str, state: DistAggState,
                       agg_calls: tuple,
                       bucket_cap: Optional[int] = None) -> DistAggState:
    """The distributed exchange: hash-partition the per-device group partials
    over the mesh (all_to_all) and merge each device's owned key range.

    bucket_cap bounds rows per (sender, receiver) pair; the default (state
    capacity) is lossless (a device sends at most its whole state to one
    peer) but ships n_dev fully-padded buckets. The driver passes a small
    cap sized to live groups (exchange traffic ∝ distinct groups) and retries
    with a bigger one on the overflow flag."""
    scap = state.keys.shape[0]
    if bucket_cap is None:
        bucket_cap = scap
    mask = jnp.arange(scap, dtype=jnp.int32) < state.count
    cols, rebuild = _flat_state_cols(state)
    rkeys, rmask, rcols, dropped = hash_partition_shuffle(
        axis_name, state.keys, mask, cols, bucket_cap=bucket_cap)
    first, partials, reps = rebuild(rcols)
    recv = DistAggState(
        jnp.where(rmask, rkeys, _I64MAX), first, partials, reps,
        jnp.sum(rmask, dtype=jnp.int32),
        jnp.logical_or(state.overflow, dropped), state.too_long)
    # receiving n_dev buckets of up to bucket_cap rows each
    n_dev = jax.lax.axis_size(axis_name)
    # recv rows are already "state rows"; re-tag liveness via rmask ordering:
    # merge_states expects live rows in slots [0, count) — compact first.
    idx, cnt = layout_ops.mask_to_indices(rmask)
    comp = _gather_state_rows(recv, idx, cnt)
    merged = merge_states([comp], agg_calls, n_dev * bucket_cap)
    # propagate flags across devices so every shard agrees
    any_over = jax.lax.psum(merged.overflow.astype(jnp.int32), axis_name) > 0
    any_long = jax.lax.psum(merged.too_long.astype(jnp.int32), axis_name) > 0
    return dataclasses.replace(merged, overflow=any_over, too_long=any_long)


def _gather_state_rows(state: DistAggState, idx, cnt) -> DistAggState:
    cap = idx.shape[0]
    slot_live = jnp.arange(cap, dtype=jnp.int32) < cnt
    safe = jnp.clip(idx, 0, cap - 1)

    def g(x, fill=0):
        v = x[safe]
        return jnp.where(
            slot_live.reshape((cap,) + (1,) * (v.ndim - 1)), v,
            jnp.asarray(fill, x.dtype))

    partials = tuple(tuple(g(c) for c in p) if isinstance(p, tuple) else g(p)
                     for p in state.partials)
    reps = tuple(
        VarRep(g(r.prefix), g(r.lens), g(r.validity, False))
        if isinstance(r, VarRep) else FixedRep(g(r.values), g(r.validity, False))
        for r in state.reps)
    return DistAggState(g(state.keys, _I64MAX), g(state.first, _I64MAX),
                        partials, reps, cnt, state.overflow, state.too_long)


# ---------------------------------------------------------------------------
# The physical operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedAggregateExec(PhysicalPlan):
    """Aggregate executed data-parallel over the mesh's ``shard`` axis.

    ``source`` yields HOST batches (the scan's decode stream);
    ``stages`` is the fused (filter/project) pipeline applied on-device.

    Cardinality is unbounded: when per-device live groups exceed
    state_cap, the accumulated state is exchanged+merged on the mesh,
    spilled to host as compact group rows, and the wave retries on fresh
    state; spilled row sets merge by key hash at finalize. Only a group
    key exceeding rep_w bytes (or a single wave whose distinct keys
    exceed state capacity) falls back to the single-device path.
    """

    group_exprs: list[Expr]
    agg_calls: list[AggregateCall]
    out_schema: Schema
    source: Callable[[], Iterator[Batch]]     # host batches
    stages: tuple                             # (kind, payload, out_schema)
    mesh: Mesh
    fallback: Optional[Callable[[], PhysicalPlan]] = None
    state_cap: int = DEFAULT_STATE_CAP
    rep_w: int = DEFAULT_REP_W

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return []

    def batches(self) -> Iterator[Batch]:
        try:
            yield self._run()
        except (RepTooLongError, StateOverflowError):
            if self.fallback is None:
                raise
            yield from self.fallback().batches()

    # -- main loop ----------------------------------------------------------

    def _run(self) -> Batch:
        grouped = bool(self.group_exprs)
        state = None
        global_rank = 0
        spills: list = []   # host-merged group rows flushed on overflow
        # multi-host: this process decodes only its file shard; waves are
        # built from local batches and assembled into the global shard axis
        # without cross-host data movement (lockstep_wave_iter)
        for wave in lockstep_wave_iter(self.source, self.mesh):
            state, global_rank, over = self._flush(state, wave, global_rank,
                                                   grouped)
            if over:
                # stay on the mesh: the fold was refused (state intact) —
                # exchange+merge the accumulated state, spill the compact
                # merged group rows to host, and retry the wave on fresh
                # state. Only a single wave whose distinct keys exceed
                # state capacity still raises → fallback.
                spills.append(self._host_rows(self._host_merged(state)))
                # the retry folds into fresh state; a wave that still
                # overflows raises inside _flush → single-device fallback
                state, global_rank, _ = self._flush(
                    None, wave, global_rank, grouped)
        if state is None and not spills:
            if grouped:
                return _empty_batch(self.out_schema)
            return self._finalize_ungrouped([])
        if grouped:
            if spills:
                if state is not None:
                    spills.append(self._host_rows(
                        self._host_merged(state)))
                rows = self._merge_spill_rows(
                    [r for r in spills if r is not None])
                if rows is None:
                    return _empty_batch(self.out_schema)
                return self._emit_rows(*rows)
            return self._finalize_grouped(state)
        return self._finalize_ungrouped(state)

    def _flush(self, state, wave: list[Batch], global_rank: int, grouped):
        """Fold one wave. Returns (state, rank, overflowed): overflowed
        means the grouped fold was REFUSED (state returned intact, rank
        unadvanced) because merging would drop groups — spill + retry."""
        multi = jax.process_count() > 1
        n_dev = self.mesh.shape["shard"]
        from .mesh import local_shard_count

        n_slots = local_shard_count(self.mesh) if multi else n_dev
        wave, cap, vcaps = pad_wave(wave, n_slots)
        wave = [pad_host_batch(b, cap, vcaps) for b in wave]
        stacked = stack_wave(wave, self.mesh)
        if grouped:
            step = _wave_step_grouped(
                self.mesh, tuple(self.group_exprs), tuple(self.agg_calls),
                self.stages, self.state_cap, self.rep_w, state is not None)
            if state is None:
                state = step(stacked, jnp.int64(global_rank), jnp.int32(cap))
                flags = gather_full((state.overflow, state.too_long),
                                    self.mesh)
                if bool(np.any(flags[1])):
                    raise RepTooLongError(
                        f"group key exceeds rep_w={self.rep_w} bytes")
                if bool(np.any(flags[0])):
                    # a single wave's distinct keys exceed state capacity:
                    # nothing to spill (the fresh fold itself truncated)
                    raise StateOverflowError(
                        f"one wave's distinct groups exceed "
                        f"state_cap={self.state_cap}")
            else:
                state, over_a, long_a = step(state, stacked,
                                             jnp.int64(global_rank),
                                             jnp.int32(cap))
                flags = gather_full((over_a, long_a), self.mesh)
                if bool(np.any(np.asarray(flags[1]))):
                    raise RepTooLongError(
                        f"group key exceeds rep_w={self.rep_w} bytes")
                if bool(np.any(np.asarray(flags[0]))):
                    return state, global_rank, True
        else:
            step = _wave_step_ungrouped(self.mesh, tuple(self.agg_calls),
                                        self.stages)
            part = step(stacked)
            state = (state or []) + [part]
        # rank space advances by the FULL shard axis (devices across all
        # processes), not just this process's local slots
        return state, global_rank + cap * n_dev, False

    # -- finalize -----------------------------------------------------------

    def _finalize_grouped(self, state: DistAggState) -> Batch:
        rows = self._host_rows(self._host_merged(state))
        if rows is None:
            return _empty_batch(self.out_schema)
        _keys, first, partials, reps = rows
        return self._emit_rows(first, partials, reps)

    def _host_merged(self, state: DistAggState) -> DistAggState:
        """Final exchange + host gather, compacted end to end so every
        transfer scales with live groups, not state capacity:

        1. slice the running state to the live-group bucket (slot axis)
           and the representative prefixes to the longest live key;
        2. all_to_all with a per-(sender,receiver) bucket sized for a
           uniform hash split (2x margin), retrying with bigger buckets
           on the overflow flag — worst-case skew degrades to the
           lossless full-state bucket, never to wrong answers;
        3. slice the merged result again before the gather to the host.
        """
        n_dev = self.mesh.shape["shard"]
        cnts = np.asarray(gather_full(state.count, self.mesh))
        pre = bucket_capacity(max(int(np.max(cnts, initial=0)), 1), 128)
        w = None
        if any(isinstance(r, VarRep) for r in state.reps):
            wmax = int(np.asarray(_rep_len_step(self.mesh)(state)))
            cur_w = next(r.prefix.shape[-1] for r in state.reps
                         if isinstance(r, VarRep))
            w = int(bucket_capacity(max(wmax, 1), 8))
            if w >= cur_w:
                w = None
        if pre < state.keys.shape[1] or w is not None:
            state = _slice_state_step(self.mesh, pre, w)(state)
        bucket = int(bucket_capacity(max(64, 2 * pre // max(n_dev, 1)), 64))
        while True:
            fin = _final_exchange(self.mesh, tuple(self.agg_calls),
                                  min(bucket, pre))
            merged = fin(state)  # sharded [n_dev, n_dev*bucket]
            flags = gather_full((merged.overflow, merged.too_long),
                                self.mesh)
            if bool(np.any(np.asarray(flags[1]))):
                raise RepTooLongError("group key exceeds rep_w bytes")
            if not bool(np.any(np.asarray(flags[0]))):
                break
            if bucket >= pre:
                # lossless bucket and still overflowing → true merge
                # overflow (one device's owned range exceeds capacity)
                raise StateOverflowError("merge overflow")
            bucket = min(bucket * 4, pre)
        cnts = np.asarray(gather_full(merged.count, self.mesh))
        maxc = bucket_capacity(max(int(np.max(cnts, initial=0)), 1), 128)
        if maxc < merged.keys.shape[1]:
            host = jax.device_get(
                _slice_state_step(self.mesh, maxc, replicate=True)(merged))
        else:
            host = gather_full(merged, self.mesh)
        return host

    def _host_rows(self, host: DistAggState):
        """Flatten a gathered merged state's disjoint per-device ranges to
        flat per-group row arrays (keys, first, partials, reps) — the
        spill format; None when no groups."""
        n_dev = host.keys.shape[0]
        keys_l, first_l = [], []
        parts_l: list[list] = [[] for _ in self.agg_calls]
        reps_l: list[list] = [[] for _ in self.group_exprs]
        for d in range(n_dev):
            c = int(host.count[d])
            if c == 0:
                continue
            keys_l.append(host.keys[d][:c])
            first_l.append(host.first[d][:c])
            for j in range(len(self.agg_calls)):
                parts_l[j].append(
                    jax.tree.map(lambda x: x[d][:c], host.partials[j]))
            for j in range(len(self.group_exprs)):
                r = host.reps[j]
                if isinstance(r, VarRep):
                    reps_l[j].append((r.prefix[d][:c], r.lens[d][:c],
                                      r.validity[d][:c]))
                else:
                    reps_l[j].append((r.values[d][:c], r.validity[d][:c]))
        if not keys_l:
            return None
        keys = np.concatenate(keys_l)
        first = np.concatenate(first_l)
        partials = []
        for j in range(len(self.agg_calls)):
            pl = parts_l[j]
            if isinstance(pl[0], tuple):
                partials.append(tuple(
                    np.concatenate([np.asarray(x[i]) for x in pl])
                    for i in range(len(pl[0]))))
            else:
                partials.append(np.concatenate([np.asarray(x) for x in pl]))
        reps = []
        for j in range(len(self.group_exprs)):
            rl = reps_l[j]
            reps.append(tuple(
                np.concatenate([np.asarray(x[i]) for x in rl])
                for i in range(len(rl[0]))))
        return keys, first, partials, reps

    def _merge_spill_rows(self, rows_list: list):
        """Merge spilled group-row sets by key hash host-side. Spills hold
        disjoint wave ranges of the SAME keys, so partials combine with
        the usual algebra (count/sum add, min/max reduce, first min)."""
        if not rows_list:
            return None
        keys = np.concatenate([r[0] for r in rows_list])
        first = np.concatenate([r[1] for r in rows_list])
        uniq, inv = np.unique(keys, return_inverse=True)
        ng = len(uniq)
        first_m = np.full(ng, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(first_m, inv, first)
        partials_m = []
        for j, call in enumerate(self.agg_calls):
            comp = [r[2][j] for r in rows_list]
            if call.fn == "count":
                cat = np.concatenate(comp)
                out = np.zeros(ng, cat.dtype)
                np.add.at(out, inv, cat)
                partials_m.append(out)
            elif call.fn in ("min", "max"):
                s = np.concatenate([c[0] for c in comp])
                cnt = np.concatenate([c[1] for c in comp])
                live = cnt > 0
                if np.issubdtype(s.dtype, np.floating):
                    ident = np.inf if call.fn == "min" else -np.inf
                else:
                    info = np.iinfo(s.dtype)
                    ident = info.max if call.fn == "min" else info.min
                out_s = np.full(ng, ident, s.dtype)
                red = np.minimum if call.fn == "min" else np.maximum
                red.at(out_s, inv[live], s[live])
                out_c = np.zeros(ng, cnt.dtype)
                np.add.at(out_c, inv, cnt)
                out_s = np.where(out_c > 0, out_s, np.zeros((), s.dtype))
                partials_m.append((out_s, out_c))
            else:  # sum/avg (and any additive tuple partial)
                width = len(comp[0])
                outs = []
                for i in range(width):
                    cat = np.concatenate([c[i] for c in comp])
                    o = np.zeros(ng, cat.dtype)
                    np.add.at(o, inv, cat)
                    outs.append(o)
                partials_m.append(tuple(outs))
        # representative key values come from the globally-first row
        order = np.lexsort((np.arange(len(first)), first))
        _g, first_pos = np.unique(inv[order], return_index=True)
        rep_rows = order[first_pos]
        reps_m = []
        for j in range(len(self.group_exprs)):
            comp = [r[3][j] for r in rows_list]
            cats = []
            for i in range(len(comp[0])):
                pieces = [np.asarray(c[i]) for c in comp]
                if pieces[0].ndim == 2:
                    # prefix widths may differ per spill (sliced to each
                    # spill's longest live key) — pad to the widest
                    W = max(p.shape[1] for p in pieces)
                    pieces = [np.pad(p, ((0, 0), (0, W - p.shape[1])))
                              if p.shape[1] < W else p for p in pieces]
                cats.append(np.concatenate(pieces))
            reps_m.append(tuple(c[rep_rows] for c in cats))
        return first_m, partials_m, reps_m

    def _emit_rows(self, first, partials, reps) -> Batch:
        """Emit flat group rows in global first-seen order (single-device
        emission parity)."""
        from .. import datatypes as dt

        order = np.argsort(first, kind="stable")
        n = order.shape[0]
        fields = self.out_schema.all_fields
        cols = []
        for j in range(len(self.group_exprs)):
            parts = reps[j]
            if len(parts) == 3:  # VarRep
                pre = np.asarray(parts[0])[order]
                lens = np.asarray(parts[1])[order]
                val = np.asarray(parts[2])[order]
                offsets = np.zeros(n + 1, np.int32)
                np.cumsum(lens, out=offsets[1:])
                # vectorized ragged compaction: row-major boolean mask pick
                keep = np.arange(pre.shape[1])[None, :] < lens[:, None]
                flat = pre[keep]
                if flat.size == 0:
                    flat = np.zeros(1, np.uint8)
                cols.append(VarColumn(flat, offsets, val))
            else:
                vals = np.asarray(parts[0])[order]
                val = np.asarray(parts[1])[order]
                npdt = dt.numpy_dtype(fields[j].dtype)
                cols.append(FixedColumn(vals.astype(npdt), val))
        for j, call in enumerate(self.agg_calls):
            f = fields[len(self.group_exprs) + j]
            npdt = dt.numpy_dtype(f.dtype)
            p = partials[j]
            if call.fn == "count":
                vals = np.asarray(p)[order]
                cols.append(FixedColumn(vals.astype(npdt), np.ones(n, bool)))
            else:
                s = np.asarray(p[0])[order]
                c = np.asarray(p[1])[order]
                nonnull = c > 0
                if call.fn == "avg":
                    vals = s.astype(np.float64) / np.maximum(c, 1)
                else:
                    vals = s
                vals = np.where(nonnull, vals.astype(npdt),
                                np.zeros((), npdt))
                cols.append(FixedColumn(vals.astype(npdt), nonnull))
        return Batch(self.out_schema, cols, np.int32(n)).to_device()

    def _finalize_ungrouped(self, parts: list) -> Batch:
        from ..plan.physical import (_empty_ungrouped, _finalize_ungrouped,
                                     _merge_ungrouped)

        if not parts:
            partials = _empty_ungrouped(self.agg_calls)
        else:
            n_dev = self.mesh.shape["shard"]
            host = gather_full(parts, self.mesh)  # per-wave [n_dev,…] pytrees
            partials = None
            for wave_part in host:
                for d in range(n_dev):
                    one = [jax.tree.map(lambda x: np.asarray(x)[d], p)
                           for p in wave_part]
                    if partials is None:
                        partials = one
                    else:
                        partials = _merge_ungrouped(partials, one,
                                                    self.agg_calls)
        cols, _ = _finalize_ungrouped(partials, self.agg_calls,
                                      self.out_schema)
        return Batch(self.out_schema, cols, np.int32(1)).to_device(capacity=128)


@functools.cache
def _slice_state_step(mesh: Mesh, maxc: int, rep_w: Optional[int] = None,
                      replicate: bool = False):
    """Jit: slice a [n_dev, S, ...] state to its live-group bucket (slot
    axis) and optionally its representative prefixes to rep_w bytes.
    replicate=False keeps the shard sharding (pre-exchange compaction —
    all_to_all volume scales with distinct groups and key widths);
    replicate=True all-gathers the sliced result (compact host fetch)."""
    spec = NamedSharding(mesh, P() if replicate else P("shard"))

    def cut(x):
        nd = getattr(x, "ndim", 0)
        if nd == 3 and rep_w is not None:  # VarRep prefixes
            return x[:, :maxc, :rep_w]
        if nd >= 2:
            return x[:, :maxc]
        return x

    return jax.jit(lambda s: jax.tree.map(cut, s), out_shardings=spec)


@functools.cache
def _rep_len_step(mesh: Mesh):
    """Jit: global max representative-key byte length over live slots
    (replicated scalar) — sizes the pre-exchange prefix slice."""
    rep = NamedSharding(mesh, P())

    def f(s: DistAggState):
        live = jnp.arange(s.keys.shape[1], dtype=jnp.int32)[None, :] \
            < s.count[:, None]
        m = jnp.int32(0)
        for r in s.reps:
            if isinstance(r, VarRep):
                m = jnp.maximum(m, jnp.max(jnp.where(live, r.lens, 0)))
        return m

    return jax.jit(f, out_shardings=rep)


# ---------------------------------------------------------------------------
# Jitted wave steps (cached per mesh/expr/shape signature)
# ---------------------------------------------------------------------------


@functools.cache
def _wave_step_grouped(mesh: Mesh, group_exprs: tuple, agg_calls: tuple,
                       stages: tuple, state_cap: int, rep_w: int,
                       has_state: bool):
    spec = P("shard")

    def per_device_new(batch: Batch, base_rank, cap):
        d = jax.lax.axis_index("shard").astype(jnp.int64)
        b = _squeeze0(batch)
        b2, mask = apply_stages(stages, b)
        t = batch_group_state(group_exprs, agg_calls, b2, mask,
                              base_rank + d * cap.astype(jnp.int64), rep_w)
        return _expand0(merge_states([t], agg_calls, state_cap))

    def per_device_update(state: DistAggState, batch: Batch, base_rank, cap):
        d = jax.lax.axis_index("shard").astype(jnp.int64)
        s = _squeeze0(state)
        b = _squeeze0(batch)
        b2, mask = apply_stages(stages, b)
        t = batch_group_state(group_exprs, agg_calls, b2, mask,
                              base_rank + d * cap.astype(jnp.int64), rep_w)
        merged = merge_states([s, t], agg_calls, state_cap)
        over = jax.lax.psum(merged.overflow.astype(jnp.int32), "shard") > 0
        long = jax.lax.psum(merged.too_long.astype(jnp.int32), "shard") > 0
        # overflow: the merge dropped groups — discard it and return the
        # INPUT state intact (donation aliases the buffer, so the caller's
        # host reference dies with the call; the returned value is the
        # only live copy). The caller spills it and retries the wave.
        out = jax.tree.map(lambda x, y: jnp.where(over, x, y), s, merged)
        out = dataclasses.replace(out, overflow=jnp.asarray(False),
                                  too_long=jnp.asarray(False))
        return _expand0(out), over[None], long[None]

    if has_state:
        fn = jax.shard_map(per_device_update, mesh=mesh,
                           in_specs=(spec, spec, P(), P()),
                           out_specs=(spec, spec, spec))
        return jax.jit(fn, donate_argnums=(0,))
    fn = jax.shard_map(per_device_new, mesh=mesh,
                       in_specs=(spec, P(), P()), out_specs=spec)
    return jax.jit(fn)


@functools.cache
def _wave_step_ungrouped(mesh: Mesh, agg_calls: tuple, stages: tuple):
    spec = P("shard")

    has_filter = any(k == "filter" for k, _p, _s in stages)

    def per_device(batch: Batch):
        b = _squeeze0(batch)
        b2, mask = apply_stages(stages, b)
        out = []
        for call in agg_calls:
            if call.fn == "count" and call.child is None and not has_filter:
                # COUNT(*): row count directly — stays correct for
                # zero-column (projection-free) scans whose capacity is 0
                out.append(jnp.asarray(b.length, jnp.int64))
            else:
                out.append(_partial_for(call, b2, mask, None, 1))
        return jax.tree.map(lambda x: jnp.asarray(x)[None], out)

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    return jax.jit(fn)


@functools.cache
def _final_exchange(mesh: Mesh, agg_calls: tuple,
                    bucket_cap: Optional[int] = None):
    spec = P("shard")

    def per_device(state: DistAggState):
        s = _squeeze0(state)
        return _expand0(exchange_and_merge("shard", s, agg_calls,
                                           bucket_cap))

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Distributed join: broadcast build side, probe sharded over the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedJoinExec(PhysicalPlan):
    """Equi-join executed data-parallel over the mesh's ``shard`` axis.

    The build side (small — annotations) is collected, key-sorted once and
    *replicated* to every device; probe batches are dealt round-robin into
    sharded waves and each device runs the vectorized searchsorted probe +
    pair emission locally inside shard_map. This is the broadcast-hash-join
    shape (the mesh analog of DataFusion's CollectLeft hash join the
    reference uses for reads×annotations, config/mod.rs:31); no shuffle is
    needed because every device owns the whole build table.

    Emission order equals the single-device JoinExec (probe stream order),
    so results are identical including row order.
    """

    probe_source: Callable[[], Iterator[Batch]]  # host batches (left)
    probe_stages: tuple                          # fused pipeline below join
    build: PhysicalPlan                          # right side (collected)
    on: list                                     # [(left_expr, right_expr)]
    how: str
    filter: Optional[Expr]
    out_schema: Schema
    mesh: Mesh

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.build]

    def batches(self) -> Iterator[Batch]:
        from ..plan.join_exec import _jit_build_sort
        from ..plan.physical import concat_batches

        rschema = self.build.schema()
        # build side replicates: in multi-host, every process recomputes it
        # from the full file set (scan-shard context is probe-only)
        build = concat_batches(rschema, list(self.build.batches()))
        right_keys = tuple(r for _, r in self.on)
        left_keys = tuple(l for l, _ in self.on)
        sorted_build, sorted_keys = _jit_build_sort(right_keys)(build)
        n_build = jnp.asarray(build.length, jnp.int32)
        sorted_build, sorted_keys, n_build = replicate_to_mesh(
            (sorted_build, sorted_keys, n_build), self.mesh)

        for wave in lockstep_wave_iter(self.probe_source, self.mesh):
            yield from self._probe_wave(wave, sorted_build, sorted_keys,
                                        n_build, left_keys)

    def _probe_wave(self, wave, sorted_build, sorted_keys, n_build,
                    left_keys):
        from .mesh import local_shard_count

        multi = jax.process_count() > 1
        n_dev = self.mesh.shape["shard"]
        n_slots = local_shard_count(self.mesh) if multi else n_dev
        wave, cap, vcaps = pad_wave(wave, n_slots)
        wave = [pad_host_batch(b, cap, vcaps) for b in wave]
        stacked = stack_wave(wave, self.mesh)
        count_step = _join_count_step(self.mesh, self.probe_stages,
                                      left_keys, self.how, tuple(self.on))
        lo, counts, out_counts, totals, lbytes, rbytes, kbytes = count_step(
            stacked, sorted_build, sorted_keys, n_build)
        totals, lbytes, rbytes, kbytes = gather_full(
            (totals, lbytes, rbytes, kbytes), self.mesh)
        max_total = int(np.max(totals, initial=0))
        if max_total == 0:
            return
        out_cap = bucket_capacity(max_total)
        from ..plan.join_exec import _emit_vcaps

        vcaps = _emit_vcaps(
            {i: int(np.max(b)) for i, b in lbytes.items()},
            {i: int(np.max(b)) for i, b in rbytes.items()},
            tuple((int(np.max(kb)), int(np.max(rb))) for kb, rb in kbytes))
        emit_step = _join_emit_step(self.mesh, self.probe_stages,
                                    self.out_schema, self.how, out_cap,
                                    tuple(self.on), self.filter, vcaps)
        out = emit_step(stacked, sorted_build, lo, counts, out_counts)
        # every process reads the full emitted wave (gather_full), so
        # multi-host results are identical everywhere; padded slots emit 0
        out = gather_full(out, self.mesh)
        for d in range(n_dev):
            b = jax.tree.map(lambda x: np.asarray(x)[d], out)
            if int(b.length):
                yield b


@functools.cache
def _join_count_step(mesh: Mesh, stages: tuple, left_keys: tuple, how: str,
                     on: tuple):
    from ..plan.join_exec import _jit_probe_plan

    spec = P("shard")

    def per_device(batch: Batch, build: Batch, sorted_keys, n_build):
        b, mask = apply_stages(stages, _squeeze0(batch))
        b = layout_ops.filter_batch(b, mask) if stages else b
        lo, counts, out_counts, total, lbytes, rbytes, kbytes = \
            _jit_probe_plan(left_keys, how, on)(b, build, sorted_keys, n_build)
        expand = lambda t: jax.tree.map(lambda x: jnp.asarray(x)[None], t)
        return (lo[None], counts[None], out_counts[None], total[None],
                expand(lbytes), expand(rbytes), expand(kbytes))

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec, P(), P(), P()),
                       out_specs=spec)
    return jax.jit(fn)


@functools.cache
def _join_emit_step(mesh: Mesh, stages: tuple, out_schema: Schema, how: str,
                    out_cap: int, on: tuple, filter_expr, vcaps: tuple):
    from ..plan.join_exec import _jit_emit

    spec = P("shard")

    def per_device(batch: Batch, build: Batch, lo, counts, out_counts):
        b, mask = apply_stages(stages, _squeeze0(batch))
        b = layout_ops.filter_batch(b, mask) if stages else b
        out = _jit_emit(out_schema, how, out_cap, on, filter_expr, vcaps)(
            b, build, lo[0], counts[0], out_counts[0])
        return _expand0(out)

    fn = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(spec, P(), spec, spec, spec),
                       out_specs=spec)
    return jax.jit(fn)


def plan_distributed_join(join_plan, config) -> Optional[PhysicalPlan]:
    """Build a DistributedJoinExec for an L.Join whose probe (left) side is a
    supported scan chain; the build (right) side lowers normally. Multi-host:
    the probe stream shards by process (lockstep_wave_iter), the build side
    replicates."""
    from ..plan import logical as L
    from ..plan.planner import create_physical_plan

    mesh = _config_mesh(config)
    if mesh is None:
        return None
    if join_plan.how not in ("inner", "left"):
        return None
    stages = []
    node = join_plan.left
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            if contains_host_fn(node.predicate):
                return None
            stages.append(("filter", node.predicate, None))
        else:
            if any(contains_host_fn(e) for e in node.exprs):
                return None
            stages.append(("project", tuple(node.exprs), node.schema()))
        node = node.input
    if not isinstance(node, L.Scan):
        return None
    if not _multihost_shardable(node):
        return None
    exprs = [x for pair in join_plan.on for x in pair]
    if join_plan.filter is not None:
        exprs.append(join_plan.filter)
    if any(contains_host_fn(e) for e in exprs):
        return None
    scan_exec = _host_scan_exec(node)
    if scan_exec is None:
        return None
    return DistributedJoinExec(
        probe_source=scan_exec.source,
        probe_stages=tuple(reversed(stages)),
        build=create_physical_plan(join_plan.right, config),
        on=join_plan.on,
        how=join_plan.how,
        filter=join_plan.filter,
        out_schema=join_plan.schema(),
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Planner hook: can this (Aggregate → [Filter|Project]* → Scan) distribute?
# ---------------------------------------------------------------------------


def plan_distributed_aggregate(agg_plan, config) -> Optional[PhysicalPlan]:
    """Build a DistributedAggregateExec for an L.Aggregate if the pipeline
    below it is a scan chain the distributed path supports; else None."""
    from ..plan import logical as L
    from ..plan.physical import AggregateExec, ScanExec
    from ..plan.planner import create_physical_plan

    mesh = _config_mesh(config)
    if mesh is None:
        return None
    stages = []
    node = agg_plan.input
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            if contains_host_fn(node.predicate):
                return None
            stages.append(("filter", node.predicate, None))
        else:
            if any(contains_host_fn(e) for e in node.exprs):
                return None
            stages.append(("project", tuple(node.exprs), node.schema()))
        node = node.input
    if not isinstance(node, L.Scan):
        return None
    if not _multihost_shardable(node):
        return None
    for e in list(agg_plan.group_exprs) + list(agg_plan.agg_exprs):
        if contains_host_fn(e):
            return None
    from ..plan.planner import infer_expr_field

    in_schema = agg_plan.input.schema()
    for call in agg_plan.agg_exprs:
        if call.fn not in ("count", "sum", "min", "max", "avg"):
            return None
        if call.fn in ("min", "max") and call.child is not None:
            # utf8 min/max runs the exact host holistic path single-device
            try:
                k = infer_expr_field(call.child, in_schema).dtype.kind.value
            except Exception:
                return None
            if k in ("utf8", "large_utf8", "dictionary", "binary"):
                return None
    # scan must be able to hand us host batches with supported column types
    scan_exec = _host_scan_exec(node)
    if scan_exec is None:
        return None
    for f in scan_exec.out_schema.all_fields:
        k = f.dtype.kind.value
        if k in ("list", "struct", "map"):
            return None
    stages = tuple(reversed(stages))

    def fallback():
        return create_physical_plan(agg_plan)

    return DistributedAggregateExec(
        group_exprs=list(agg_plan.group_exprs),
        agg_calls=list(agg_plan.agg_exprs),
        out_schema=agg_plan.schema(),
        source=scan_exec.source,
        stages=stages,
        mesh=mesh,
        fallback=fallback,
    )


def _host_scan_exec(node):
    """Physical scan that yields host batches (device transfer is ours)."""
    from ..plan.physical import ScanExec

    kwargs = {}
    if getattr(node, "prefix_hints", None):
        kwargs["prefix_hints"] = node.prefix_hints
    try:
        exec_ = node.provider.scan(node.projection, list(node.filters),
                                   node.fetch, host_batches=True, **kwargs)
    except TypeError:
        exec_ = node.provider.scan(node.projection, list(node.filters),
                                   node.fetch)
    if not isinstance(exec_, ScanExec) or not exec_.to_device:
        return None
    return exec_


def _config_mesh(config) -> Optional[Mesh]:
    if config is None or not getattr(config, "distributed", False):
        return None
    mesh = getattr(config, "_mesh", None)
    if mesh is None:
        n = getattr(config, "n_shards", 0) or None
        try:
            mesh = make_mesh(n)
        except ValueError:
            return None
        config._mesh = mesh
    return mesh


# ---------------------------------------------------------------------------
# Distributed TopK (ORDER BY … LIMIT k)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedTopKExec(PhysicalPlan):
    """Sort+Limit over the mesh: per-device exact top-K inside shard_map per
    wave (key eval, radix sort over 8-byte chunks, row gather — all on
    device); the driver merges only the (waves x n_dev x K) candidate rows
    with the exact single-device sort. Replaces the role of DataFusion's
    SortPreservingMerge over repartitioned TopK (config/mod.rs:40-43)."""

    keys: list          # [(Expr, ascending)]
    fetch: int
    out_schema: Schema
    source: Callable[[], Iterator[Batch]]
    stages: tuple
    mesh: Mesh
    fallback: Callable[[], PhysicalPlan]

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return []

    def batches(self) -> Iterator[Batch]:
        yield self._run()

    def _run(self) -> Batch:
        from ..plan.physical import SortExec

        cands: list[Batch] = []
        for wave in lockstep_wave_iter(self.source, self.mesh):
            cands.extend(self._wave(wave))
        out = list(SortExec(self.keys, _Materialized(self.out_schema, cands),
                            self.fetch).batches())
        return out[0]

    def _wave(self, wave: list[Batch]) -> list[Batch]:
        from .mesh import local_shard_count

        multi = jax.process_count() > 1
        n_dev = self.mesh.shape["shard"]
        n_slots = local_shard_count(self.mesh) if multi else n_dev
        wave, cap, vcaps = pad_wave(wave, n_slots)
        wave = [pad_host_batch(b, cap, vcaps) for b in wave]
        stacked = stack_wave(wave, self.mesh)
        keys = tuple((e, asc) for e, asc in self.keys)
        widths = jax.device_get(
            _key_width_step(self.mesh, self.stages, keys)(stacked))
        specs = []
        for (e, asc), (w, is_var) in zip(keys, widths):
            if int(np.asarray(is_var)[0]):
                specs.append((e, asc,
                              max(1, (int(np.asarray(w)[0]) + 7) // 8)))
            else:
                specs.append((e, asc, 0))
        specs = tuple(specs)
        k = bucket_capacity(min(self.fetch, cap), 128)
        out = _topk_step(self.mesh, self.stages, specs, k)(stacked)
        # every process reads the full candidate set → identical final sort
        out = gather_full(out, self.mesh)
        res = []
        for d in range(n_dev):
            b = jax.tree.map(lambda x: np.asarray(x)[d], out)
            if int(b.length):
                res.append(b)
        return res


class _Materialized(PhysicalPlan):
    def __init__(self, schema: Schema, batches: list[Batch]):
        self._schema = schema
        self._batches = batches

    def schema(self) -> Schema:
        return self._schema

    def children(self):
        return []

    def batches(self) -> Iterator[Batch]:
        return iter(self._batches)


@functools.cache
def _key_width_step(mesh: Mesh, stages: tuple, keys: tuple):
    """Per sort key: (max row length across the wave, is_var flag)."""
    spec = P("shard")

    def per_device(batch: Batch):
        from ..plan.expressions import NullsOrder

        b, mask = apply_stages(stages, _squeeze0(batch))
        outs = []
        for e, _asc in keys:
            if isinstance(e, NullsOrder):
                e = e.child
            v = eval_expr(e, b)
            if isinstance(v, VarColumn):
                ml = jnp.max(jnp.where(
                    jnp.logical_and(mask, v.validity),
                    layout_ops.row_lengths(v.offsets), 0))
                outs.append((jax.lax.pmax(ml, "shard")[None],
                             jnp.ones(1, jnp.int32)))
            else:
                outs.append((jnp.zeros(1, jnp.int32),
                             jnp.zeros(1, jnp.int32)))
        return tuple(outs)

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec,),
                       out_specs=P())
    return jax.jit(fn)


@functools.cache
def _topk_step(mesh: Mesh, stages: tuple, specs: tuple, k: int):
    from ..plan.physical import sort_permutation

    spec = P("shard")

    def per_device(batch: Batch):
        b, mask = apply_stages(stages, _squeeze0(batch))
        b = layout_ops.filter_batch(b, mask)
        perm = sort_permutation(b, specs)
        cnt = jnp.minimum(jnp.asarray(b.length, jnp.int32), k)
        out = layout_ops.take_batch(b, perm[:k], cnt)
        return _expand0(out)

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    return jax.jit(fn)


MAX_DIST_TOPK = 1 << 16


def plan_distributed_topk(sort_plan, fetch: int, config
                          ) -> Optional[PhysicalPlan]:
    """Lower Sort(keys)+Limit(fetch) over a scan chain to the mesh.
    Multi-host: per-process file shards feed lockstep waves; the tiny
    candidate set gathers to every process for the identical final sort."""

    from ..plan import logical as L
    from ..plan.planner import create_physical_plan

    mesh = _config_mesh(config)
    if mesh is None:
        return None
    if fetch is None or fetch > MAX_DIST_TOPK:
        return None
    stages = []
    node = sort_plan.input
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            if contains_host_fn(node.predicate):
                return None
            stages.append(("filter", node.predicate, None))
        else:
            if any(contains_host_fn(e) for e in node.exprs):
                return None
            stages.append(("project", tuple(node.exprs), node.schema()))
        node = node.input
    if not isinstance(node, L.Scan):
        return None
    if not _multihost_shardable(node):
        return None
    if any(contains_host_fn(e) for e, _ in sort_plan.keys):
        return None
    scan_exec = _host_scan_exec(node)
    if scan_exec is None:
        return None
    for f in scan_exec.out_schema.all_fields:
        if f.dtype.kind.value in ("list", "struct", "map"):
            return None

    def fallback():
        return create_physical_plan(sort_plan)

    return DistributedTopKExec(
        keys=list(sort_plan.keys),
        fetch=fetch,
        out_schema=sort_plan.schema(),
        source=scan_exec.source,
        stages=tuple(reversed(stages)),
        mesh=mesh,
        fallback=fallback,
    )


# ---------------------------------------------------------------------------
# Distributed window functions: partition-sharded OVER computation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedWindowExec(PhysicalPlan):
    """OVER (PARTITION BY …) computed data-parallel over the mesh.

    Rows hash-partition across devices by their partition key (device d
    owns hash % n_dev == d), so every partition lands wholly on one device;
    each device runs the engine's fused window kernel (_window_column:
    sort → segment ids → segment reductions) on its shard inside one
    shard_map, and the results scatter back to original row order. Late
    materialization: only the columns the calls reference travel to
    devices; the payload stays host-side Arrow. Exact parity with the
    single-device WindowExec, row order included. Takes over the role of
    DataFusion's repartitioned window execution
    (exon-core/src/config/mod.rs:41 repartition_windows)."""

    calls: list
    names: list[str]
    out_schema: Schema
    input: PhysicalPlan
    mesh: Mesh

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        import contextlib

        import pyarrow as pa

        from ..plan.physical import _emit_table, _empty_batch
        from ..plan.planner import expr_columns
        from .mesh import scan_shard_context

        multi = jax.process_count() > 1
        in_schema = self.input.schema()
        part_exprs = tuple(self.calls[0].partition_by)
        key_step = _pjoin_key_step(part_exprs)
        rbs, hashes = [], []
        # multi-host: each process decodes only its file shard; the decoded
        # payload is exchanged once below so every process emits the full,
        # identical result
        ctx = scan_shard_context(jax.process_index(), jax.process_count()) \
            if multi else contextlib.nullcontext()
        with ctx:
            for b in self.input.batches():
                k, _m = jax.device_get(key_step(b))
                n = b.num_rows_host()
                if n == 0:
                    continue
                hashes.append(np.asarray(k)[:n])
                rbs.append(b.to_arrow())
        if multi:
            local = (pa.Table.from_batches(rbs) if rbs else None,
                     np.concatenate(hashes) if hashes else None)
            parts = allgather_pickled(local)
            tabs = [t for t, _h in parts if t is not None]
            if not tabs:
                yield _empty_batch(self.out_schema)
                return
            tab = pa.concat_tables(tabs).combine_chunks()
            h = np.concatenate([hh for _t, hh in parts if hh is not None])
        else:
            if not rbs:
                yield _empty_batch(self.out_schema)
                return
            tab = pa.Table.from_batches(rbs)
            h = np.concatenate(hashes)
        n = len(h)
        n_dev = self.mesh.shape["shard"]
        dev = ((h % n_dev) + n_dev) % n_dev
        order = np.argsort(dev, kind="stable")
        counts = np.bincount(dev, minlength=n_dev)
        offs = np.zeros(n_dev + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        # only the columns the calls touch go to devices
        need: set = set()
        for c in self.calls:
            for e in c.children():
                need |= expr_columns(e)
        need_cols = [nm for nm in in_schema.names if nm in need]
        if not need_cols:
            need_cols = [in_schema.names[0]]
        sub_schema = in_schema.project(need_cols)
        taken = tab.select(need_cols).take(pa.array(order))
        dev_batches = []
        for d in range(n_dev):
            piece = taken.slice(int(offs[d]), int(counts[d])).combine_chunks()
            if piece.num_rows:
                rb = piece.to_batches()[0]
                dev_batches.append(Batch.from_arrow(rb, sub_schema))
            else:
                dev_batches.append(
                    _empty_batch(sub_schema))
        cap, vcaps = wave_shape(dev_batches)
        dev_batches = [pad_host_batch(b, cap, vcaps) for b in dev_batches]
        if multi:
            # all processes hold identical dev_batches; each contributes
            # only its addressable shard rows to the global array
            rows = local_row_indices(self.mesh)
            stacked = stack_wave([dev_batches[r] for r in rows], self.mesh)
        else:
            stacked = stack_wave(dev_batches, self.mesh)
        step = _dist_window_step(self.mesh, tuple(self.calls))
        outs = gather_full(step(stacked), self.mesh)
        # scatter each call's [n_dev, cap] result back to input row order
        arrays = []
        for j, (call, name) in enumerate(zip(self.calls, self.names)):
            vals, valid = outs[j]
            flat_v = np.concatenate(
                [np.asarray(vals)[d][:counts[d]] for d in range(n_dev)])
            flat_m = np.concatenate(
                [np.asarray(valid)[d][:counts[d]] for d in range(n_dev)])
            col_v = np.empty(n, flat_v.dtype)
            col_m = np.empty(n, bool)
            col_v[order] = flat_v
            col_m[order] = flat_m
            from ..batch import arrow_type

            field = self.out_schema.all_fields[len(in_schema.names) + j]
            arrays.append(pa.array(col_v, mask=~col_m)
                          .cast(arrow_type(field.dtype)))
        out = tab
        for name, arr in zip(self.names, arrays):
            out = out.append_column(name, arr)
        yield from _emit_table(out, self.out_schema)


@functools.cache
def _dist_window_step(mesh: Mesh, calls: tuple):
    from ..plan.window_exec import _window_column

    spec = P("shard")

    def per_device(batch: Batch):
        b = _squeeze0(batch)
        outs = []
        for call in calls:
            vals, valid = _window_column(call, b)
            outs.append((jnp.asarray(vals)[None], jnp.asarray(valid)[None]))
        return tuple(outs)

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
    return jax.jit(fn)


def plan_distributed_window(win_plan, config) -> Optional[PhysicalPlan]:
    """Route an L.Window to the mesh when every call shares one non-empty
    PARTITION BY (partitions are the unit of data parallelism). Multi-host
    additionally requires a scan-rooted input so per-process ingest
    sharding yields disjoint row shards."""
    from ..plan import logical as L
    from ..plan.planner import create_physical_plan
    from ..plan.window_exec import WINDOW_FUNCS

    if jax.process_count() > 1 and not _scan_chain(win_plan.input):
        return None
    mesh = _config_mesh(config)
    if mesh is None:
        return None
    calls = win_plan.calls
    if not calls or not calls[0].partition_by:
        return None
    first = [repr(e) for e in calls[0].partition_by]
    for c in calls:
        if c.fn not in WINDOW_FUNCS:
            return None
        if [repr(e) for e in c.partition_by] != first:
            return None
        for e in c.children():
            if contains_host_fn(e):
                return None
    return DistributedWindowExec(
        calls=list(calls),
        names=list(win_plan.names),
        out_schema=win_plan.schema(),
        input=create_physical_plan(win_plan.input, config),
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Multi-host full ORDER BY: per-process sorted runs + cross-process merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedSortExec(PhysicalPlan):
    """Full ORDER BY across processes.

    Each process external-run-sorts only its file shard (the expensive
    decode + sort work parallelizes N-way), producing one merged
    (arrow table, byte-comparable key matrix, chunk widths) run — the
    exact artifact the single-process external sort spills. The runs are
    exchanged once across processes and merged with the same searchsorted ladder
    (_merge_runs), so every process emits the identical fully sorted
    table. Ties resolve process-major (process 0's rows first) —
    deterministic and identical everywhere. Takes over the role of
    DataFusion's repartitioned sort (exon-core/src/config/mod.rs:40-43
    repartition_sorts) on the multi-host axis."""

    keys: list          # [(Expr, ascending)]
    input: PhysicalPlan
    fetch: Optional[int]
    mesh: Mesh

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def batches(self) -> Iterator[Batch]:
        from ..plan.physical import (SortExec, _emit_table, _empty_batch,
                                     _merge_runs)
        from .mesh import scan_shard_context

        inner = SortExec(self.keys, self.input, self.fetch)
        with scan_shard_context(jax.process_index(), jax.process_count()):
            run = inner.merged_run()
        runs = [r for r in allgather_pickled(run) if r is not None]
        if not runs:
            yield _empty_batch(self.schema())
            return
        tab = _merge_runs(runs, [a for _e, a in self.keys])[0]
        if self.fetch is not None:
            tab = tab.slice(0, self.fetch)
        yield from _emit_table(tab, self.schema())


def plan_distributed_sort(sort_plan, config) -> Optional[PhysicalPlan]:
    """Route a full L.Sort to per-process sharded execution. Only fires
    multi-host (the single-process external run sort already parallelizes
    ingest) and only over a scan-rooted input (disjoint row shards)."""
    if jax.process_count() <= 1:
        return None
    if not _scan_chain(sort_plan.input):
        return None
    mesh = _config_mesh(config)
    if mesh is None:
        return None
    if any(contains_host_fn(e) for e, _a in sort_plan.keys):
        return None
    from ..plan.planner import create_physical_plan

    return DistributedSortExec(
        keys=list(sort_plan.keys),
        input=create_physical_plan(sort_plan.input, config),
        fetch=sort_plan.fetch,
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# Partitioned (non-broadcast) join: all_to_all by key hash
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedPartitionedJoinExec(PhysicalPlan):
    """Equi-join with BOTH sides hash-partitioned over the mesh.

    The broadcast-probe DistributedJoinExec replicates the whole build side
    to every device — wrong shape when both sides are large. Here each side
    is partitioned by a splittable hash of the join key inside ``shard_map``
    and exchanged with one ``lax.all_to_all``, so every key group lands
    wholly on one device and the match computation parallelizes with no
    replication (the mesh analog of DataFusion's Partitioned hash-join mode,
    exon-core/src/config/mod.rs:31).

    Late materialization keeps exchange traffic minimal: only (key-hash i64,
    row-id i32) pairs ride the exchange; matching emits (left_row,
    right_row) index pairs, and rows materialize host-side with one
    vectorized Arrow ``take`` per side. Output ordering is normalized to
    probe-stream order (stable lexsort of the pair list), so results are
    IDENTICAL to the single-device JoinExec, row order included.

    Key equality uses the engine's 64-bit content hash for var-width keys —
    the same guarantee the grouped aggregate documents (collision odds
    ~ n²/2⁻⁶⁴, plan/physical.py _group_key_i64).
    """

    left: PhysicalPlan
    right: PhysicalPlan
    on: list
    how: str  # inner | left
    filter: Optional[object]
    out_schema: Schema
    mesh: Mesh

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.left, self.right]

    def batches(self) -> Iterator[Batch]:
        import pyarrow as pa

        from ..plan.physical import FilterExec

        lexprs = tuple(l for l, _ in self.on)
        rexprs = tuple(r for _, r in self.on)
        ltab, lkeys, lvalid = _collect_side(self.left, lexprs, self.mesh)
        rtab, rkeys, rvalid = _collect_side(self.right, rexprs, self.mesh)
        nL = len(lkeys)
        if nL == 0:
            return
        lidx = np.flatnonzero(lvalid).astype(np.int32)
        ridx = np.flatnonzero(rvalid).astype(np.int32)
        pairs = _exchange_match_pairs(self.mesh, lkeys[lidx], lidx,
                                      rkeys[ridx], ridx, self.how)
        if self.how == "left":
            inv = np.flatnonzero(~lvalid).astype(np.int32)
            if len(inv):
                extra = np.stack([inv, np.full(len(inv), -1, np.int32)], 1)
                pairs = np.concatenate([pairs, extra]) if len(pairs) \
                    else extra
        if len(pairs) == 0:
            return
        # normalize to probe order; within a probe row, build-row order
        # (matches JoinExec's stable sorted-build emission)
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        pairs = pairs[order]
        l_take = pa.array(pairs[:, 0].astype(np.int64))
        rvals = pairs[:, 1].astype(np.int64)
        r_take = pa.array(rvals, mask=rvals < 0)
        ltaken = ltab.take(l_take)
        rtaken = rtab.take(r_take)
        arrays = list(ltaken.columns) + list(rtaken.columns)
        out = pa.table(dict(zip(self.out_schema.names,
                                [a.combine_chunks() for a in arrays])))
        bs = 8192
        out_batches = []
        for lo in range(0, out.num_rows, bs):
            rb = out.slice(lo, min(bs, out.num_rows - lo)).to_batches()
            for b in rb:
                if b.num_rows:
                    out_batches.append(
                        Batch.from_arrow(b, self.out_schema))
        inner = _Materialized(self.out_schema, out_batches)
        plan = FilterExec(self.filter, inner) if self.filter is not None \
            else inner
        yield from plan.batches()


def _collect_side(side: PhysicalPlan, key_exprs: tuple,
                  mesh: Optional[Mesh] = None):
    """Stream a side once: host Arrow table + int64 content key + valid
    mask per row (keys evaluated on device, only keys transferred back).

    Multi-host: the stream runs under the process file shard and the
    decoded (table, keys, valid) triple is exchanged once, so every
    process holds the identical global side while decoding only 1/N of
    the input."""
    import contextlib

    import pyarrow as pa

    from ..batch import arrow_type
    from .mesh import scan_shard_context

    multi = jax.process_count() > 1
    schema = side.schema()
    rbs, keys, valids = [], [], []
    ctx = scan_shard_context(jax.process_index(), jax.process_count()) \
        if multi else contextlib.nullcontext()
    with ctx:
        for b in side.batches():
            step = _pjoin_key_step(key_exprs)
            k, m = step(b)
            k, m = jax.device_get((k, m))
            n = b.num_rows_host()
            keys.append(np.asarray(k)[:n])
            valids.append(np.asarray(m)[:n])
            rbs.append(b.to_arrow())
    if multi:
        local = ((pa.Table.from_batches(rbs), np.concatenate(keys),
                  np.concatenate(valids)) if rbs else None)
        parts = [p for p in allgather_pickled(local) if p is not None]
        if parts:
            return (pa.concat_tables([t for t, _k, _v in parts]
                                     ).combine_chunks(),
                    np.concatenate([k for _t, k, _v in parts]),
                    np.concatenate([v for _t, _k, v in parts]))
    elif rbs:
        tab = pa.Table.from_batches(rbs)
        return (tab, np.concatenate(keys), np.concatenate(valids))
    tab = pa.table({f.name: pa.array([], type=arrow_type(f.dtype))
                    for f in schema.all_fields})
    return tab, np.zeros(0, np.int64), np.zeros(0, bool)


@functools.cache
def _pjoin_key_step(key_exprs: tuple):
    from ..plan.physical import _group_key_i64, _group_key_valid

    @jax.jit
    def step(b: Batch):
        # mask excludes null-key rows (SQL join equality); window
        # partition hashing uses only the key (NULLs form one partition
        # via the key sentinel)
        return (_group_key_i64(key_exprs, b),
                jnp.logical_and(b.row_mask(),
                                _group_key_valid(key_exprs, b)))

    return step


def _exchange_match_pairs(mesh: Mesh, lkeys, lrow, rkeys, rrow, how: str,
                          max_tries: int = 3) -> np.ndarray:
    """Partition both key lists over the mesh, match per device, return
    (left_row, right_row) pairs (right −1 = unmatched left, how='left')."""
    n_dev = mesh.shape["shard"]

    def stage(keys, rows):
        chunk = max(1, -(-len(keys) // n_dev))
        pad = chunk * n_dev - len(keys)
        k = np.pad(keys, (0, pad)).reshape(n_dev, chunk)
        r = np.pad(rows, (0, pad)).reshape(n_dev, chunk).astype(np.int32)
        m = np.arange(chunk)[None, :] + np.arange(n_dev)[:, None] * chunk \
            < len(keys)
        # multi-host: every process holds the identical global staging
        # arrays (allgathered sides) and contributes its local rows
        return put_sharded_rows((k, r, m), mesh)

    lk, lr, lm = stage(lkeys, lrow)
    rk, rr, rm = stage(rkeys, rrow)
    bucket_cap = int(bucket_capacity(
        max(64, 2 * max(len(lkeys), len(rkeys), 1) // max(n_dev, 1) + 64)))
    for attempt in range(max_tries):
        count_step = _pjoin_count_step(mesh, how, bucket_cap)
        totals, ovf = gather_full(count_step(lk, lr, lm, rk, rr, rm), mesh)
        if bool(np.asarray(ovf).any()):
            bucket_cap *= 4
            continue
        max_total = int(np.max(totals, initial=0))
        if max_total == 0:
            return np.zeros((0, 2), np.int32)
        out_cap = int(bucket_capacity(max_total))
        emit_step = _pjoin_emit_step(mesh, how, bucket_cap, out_cap)
        pairs, npairs = gather_full(emit_step(lk, lr, lm, rk, rr, rm), mesh)
        out = [pairs[d, :int(npairs[d])] for d in range(n_dev)]
        return np.concatenate(out) if out else np.zeros((0, 2), np.int32)
    raise StateOverflowError(
        f"partitioned join bucket overflow at cap {bucket_cap} "
        f"(pathological key skew); use the broadcast join")


def _pjoin_local(axis, how: str, bucket_cap: int, lk, lr, lm, rk, rr, rm):
    """Inside shard_map: exchange both sides, locally match. Returns
    (recv left row/mask, counts, lo, sorted right rows, n_out)."""
    from .shuffle import hash_partition_shuffle

    lk2, lm2, (lr2,), ovl = hash_partition_shuffle(
        axis, lk, lm, [lr], bucket_cap)
    rk2, rm2, (rr2,), ovr = hash_partition_shuffle(
        axis, rk, rm, [rr], bucket_cap)
    big = jnp.int64(1) << jnp.int64(62)
    rk_s = jnp.where(rm2, rk2, big)
    perm = jnp.argsort(rk_s, stable=True).astype(jnp.int32)
    rk_sorted = rk_s[perm]
    rr_sorted = rr2[perm]
    lo = jnp.searchsorted(rk_sorted, lk2, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(rk_sorted, lk2, side="right").astype(jnp.int32)
    counts = jnp.where(lm2, hi - lo, 0).astype(jnp.int32)
    out_counts = jnp.maximum(counts, lm2.astype(jnp.int32)) \
        if how == "left" else counts
    return lm2, lr2, counts, out_counts, lo, rr_sorted, ovl | ovr


def _pjoin_count_step(mesh: Mesh, how: str, bucket_cap: int):
    spec = P("shard")

    def per_device(lk, lr, lm, rk, rr, rm):
        res = _pjoin_local("shard", how, bucket_cap, lk[0], lr[0], lm[0],
                           rk[0], rr[0], rm[0])
        _lm2, _lr2, _counts, out_counts, _lo, _rr_s, ovf = res
        return jnp.sum(out_counts)[None], ovf[None]

    fn = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(spec,) * 6, out_specs=spec)
    return jax.jit(fn)


def _pjoin_emit_step(mesh: Mesh, how: str, bucket_cap: int, out_cap: int):
    spec = P("shard")

    def per_device(lk, lr, lm, rk, rr, rm):
        lm2, lr2, counts, out_counts, lo, rr_sorted, _ovf = _pjoin_local(
            "shard", how, bucket_cap, lk[0], lr[0], lm[0],
            rk[0], rr[0], rm[0])
        cum = jnp.cumsum(out_counts)
        starts = cum - out_counts
        slot = jnp.arange(out_cap, dtype=jnp.int32)
        li = jnp.searchsorted(cum, slot, side="right").astype(jnp.int32)
        li_c = jnp.clip(li, 0, lm2.shape[0] - 1)
        within = slot - starts[li_c]
        n_out = cum[-1] if cum.shape[0] else jnp.int32(0)
        valid = slot < n_out
        r_sorted_idx = jnp.clip(lo[li_c] + within, 0,
                                rr_sorted.shape[0] - 1)
        matched = counts[li_c] > 0
        rout = jnp.where(matched, rr_sorted[r_sorted_idx], -1)
        lout = lr2[li_c]
        pairs = jnp.stack([jnp.where(valid, lout, 0),
                           jnp.where(valid, rout, 0)], axis=1)
        return pairs[None], n_out.astype(jnp.int32)[None]

    fn = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(spec,) * 6, out_specs=spec)
    return jax.jit(fn)


def plan_distributed_partitioned_join(join_plan, config
                                      ) -> Optional[PhysicalPlan]:
    """Planner hook: SET exon.partitioned_join = true selects the
    partitioned exchange over the default broadcast-probe join. Multi-host
    requires both sides scan-rooted (disjoint per-process row shards)."""
    if jax.process_count() > 1 and not (
            _scan_chain(join_plan.left) and _scan_chain(join_plan.right)):
        return None

    from ..plan import logical as L
    from ..plan.planner import create_physical_plan

    mesh = _config_mesh(config)
    if mesh is None:
        return None
    if join_plan.how not in ("inner", "left"):
        return None
    exprs = [x for pair in join_plan.on for x in pair]
    if join_plan.filter is not None:
        exprs.append(join_plan.filter)
    if any(contains_host_fn(e) for e in exprs):
        return None
    return DistributedPartitionedJoinExec(
        left=create_physical_plan(join_plan.left, config),
        right=create_physical_plan(join_plan.right, config),
        on=join_plan.on,
        how=join_plan.how,
        filter=join_plan.filter,
        out_schema=join_plan.schema(),
        mesh=mesh,
    )
