"""Hash-equi-join as sorted build side + searchsorted probe.

The reference uses DataFusion's repartitioned hash join (config/mod.rs:31);
scalar-probe hash tables are the wrong shape for a vector machine, so the
device plan is:

  build:  collect build side → pack join keys to int64 → one XLA sort
  probe:  per streamed batch, two vectorized searchsorted passes give each
          probe row its [lo, hi) match range; segment expansion materializes
          the pairs; gathers assemble the output batch

String keys join on a 64-bit structural hash and are re-verified with an
exact byte-equality residual filter, so results are exact.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import (Batch, DictColumn, FixedColumn, Schema, VarColumn,
                     bucket_capacity)
from ..errors import PlanError
from ..ops import layout as layout_ops
from .expressions import Expr, eval_expr, as_bool_mask
from .physical import (PhysicalPlan, _group_key_i64, _group_key_valid,
                       concat_batches,
                       sort_permutation)


def join_schema(lschema: Schema, rschema: Schema,
                right_names: dict | None = None) -> tuple[Schema, list[str]]:
    """Left fields + right fields; right-side name collisions get a
    ':right'-style suffix (DataFusion would qualify with the table name).
    ``right_names`` (pinned at plan time) overrides the collision-derived
    renames so the mapping survives projection pushdown."""
    lnames = {f.name for f in lschema.all_fields}
    fields = list(lschema.all_fields)
    rnames = []
    for f in rschema.all_fields:
        if right_names is not None and f.name in right_names:
            name = right_names[f.name]
        else:
            name = f.name
            if name in lnames:
                name = name + "_right"
        rnames.append(name)
        fields.append(dataclasses.replace(f, name=name))
    return Schema(tuple(fields)), rnames


@dataclasses.dataclass
class JoinExec(PhysicalPlan):
    left: PhysicalPlan    # probe side (streamed)
    right: PhysicalPlan   # build side (collected)
    on: list              # [(left_expr, right_expr)]
    how: str              # inner | left
    filter: Optional[Expr]
    out_schema: Schema

    def children(self):
        return [self.left, self.right]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        rschema = self.right.schema()
        build = concat_batches(rschema, list(self.right.batches()))
        n_build = build.num_rows_host()
        right_keys = tuple(r for _, r in self.on)
        left_keys = tuple(l for l, _ in self.on)

        sort_step = _jit_build_sort(right_keys)
        sorted_build, sorted_keys = sort_step(build)

        probe_step = _jit_probe_plan(left_keys, self.how, tuple(self.on))
        for pb in self.left.batches():
            lo, counts, out_counts, total, lbytes, rbytes, kbytes = \
                probe_step(pb, sorted_build, sorted_keys,
                           jnp.asarray(build.length, jnp.int32))
            tot, lbytes, rbytes, kbytes = jax.device_get(
                (total, lbytes, rbytes, kbytes))
            if int(tot) == 0:
                continue
            out_cap = bucket_capacity(int(tot))
            vcaps = _emit_vcaps(lbytes, rbytes, kbytes)
            emit = _jit_emit(self.out_schema, self.how, out_cap,
                             tuple(self.on), self.filter, vcaps)
            yield emit(pb, sorted_build, lo, counts, out_counts)


@functools.cache
def _jit_build_sort(right_keys: tuple):
    @jax.jit
    def step(build: Batch):
        keys = _group_key_i64(right_keys, build)
        # null-key build rows can never match (SQL equality) — padding
        mask = jnp.logical_and(build.row_mask(),
                               _group_key_valid(right_keys, build))
        # padding rows must sort AFTER every real key without aliasing any
        # real value: a finite sentinel (the old 1<<62) silently dropped
        # all matches for keys hashing above it (~1/8 of the hash space,
        # since the probe clips match ranges at n_build). Two stable
        # argsorts order by (is_padding, key); the stored keys then
        # overwrite the padding tail with int64 max so searchsorted sees a
        # sorted array, and the probe's clip at n_build excludes the tail
        # exactly — even for real keys equal to int64 max.
        perm1 = jnp.argsort(keys, stable=True).astype(jnp.int32)
        pad_last = jnp.argsort(jnp.logical_not(mask)[perm1], stable=True)
        perm = perm1[pad_last].astype(jnp.int32)
        # live cutoff = masked rows (null-key rows count as padding, so
        # their sentinel keys must fall in the overwritten tail)
        n = jnp.sum(mask, dtype=jnp.int32)
        sorted_build = layout_ops.take_batch(build, perm, n)
        skeys = jnp.where(
            jnp.arange(keys.shape[0], dtype=jnp.int32) < n,
            keys[perm], jnp.iinfo(jnp.int64).max)
        return sorted_build, skeys

    return step


@functools.cache
def _jit_probe_counts(left_keys: tuple):
    @jax.jit
    def step(pb: Batch, sorted_keys, n_build):
        keys = _group_key_i64(left_keys, pb)
        mask = jnp.logical_and(pb.row_mask(),
                               _group_key_valid(left_keys, pb))
        lo = jnp.searchsorted(sorted_keys, keys, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(sorted_keys, keys, side="right").astype(jnp.int32)
        lo = jnp.minimum(lo, n_build)
        hi = jnp.minimum(hi, n_build)
        counts = jnp.where(mask, hi - lo, 0).astype(jnp.int32)
        return lo, hi, counts, jnp.sum(counts)

    return step


def _emit_byte_totals(pb: Batch, build: Batch, on: tuple, how: str,
                      lo, counts, out_counts):
    """Exact output byte totals per var-width column — the emit kernels lay
    every gathered copy out flat, so buffers must be sized to the EXPANDED
    row set, not the input's (the pre-fix overflow corrupted offsets on
    row-expanding joins)."""
    from ..ops.layout import row_lengths

    oc64 = out_counts.astype(jnp.int64)
    lbytes = {}
    for i, c in enumerate(pb.columns):
        if isinstance(c, VarColumn):
            lbytes[i] = jnp.sum(oc64 * row_lengths(c.offsets).astype(jnp.int64))
    unmatched = jnp.logical_and(out_counts > 0, counts == 0)
    rbytes = {}
    for i, c in enumerate(build.columns):
        if isinstance(c, VarColumn):
            rbytes[i] = _range_bytes(c, lo, counts, unmatched, build.capacity)
    kbytes = []
    for le, re in on:
        lv = eval_expr(le, pb)
        kb = (jnp.sum(oc64 * row_lengths(lv.offsets).astype(jnp.int64))
              if isinstance(lv, VarColumn) else jnp.int64(0))
        rb = jnp.int64(0)
        if isinstance(lv, VarColumn):
            rv = eval_expr(re, build)
            if isinstance(rv, DictColumn):
                rv = layout_ops.dict_to_var(rv)
            if isinstance(rv, VarColumn):
                rb = _range_bytes(rv, lo, counts, unmatched, build.capacity)
        kbytes.append((kb, rb))
    return lbytes, rbytes, tuple(kbytes)


def _range_bytes(col: VarColumn, lo, counts, unmatched, build_cap):
    """Bytes emitted from a build var column: matched ranges [lo, lo+counts)
    plus — for left joins — the single clipped row each unmatched probe row
    gathers (its bytes are laid out even though validity is nulled)."""
    from ..ops.layout import row_lengths

    lens = row_lengths(col.offsets).astype(jnp.int64)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int64),
                           jnp.cumsum(lens, dtype=jnp.int64)])
    n = cum.shape[0] - 1
    hi_idx = jnp.clip(lo + counts, 0, n)
    lo_idx = jnp.clip(lo, 0, n)
    matched = jnp.sum(cum[hi_idx] - cum[lo_idx])
    pad = jnp.sum(jnp.where(unmatched,
                            lens[jnp.clip(lo, 0, build_cap - 1)], 0))
    return matched + pad


@functools.cache
def _jit_probe_plan(left_keys: tuple, how: str, on: tuple):
    """Count pass: match ranges, output row count, and exact per-column
    output byte totals (one host sync delivers everything the emit pass
    needs to pick static shapes)."""

    @jax.jit
    def step(pb: Batch, build: Batch, sorted_keys, n_build):
        keys = _group_key_i64(left_keys, pb)
        mask = pb.row_mask()
        # null-key probe rows match nothing (SQL equality); for LEFT they
        # still emit once, unmatched
        kmask = jnp.logical_and(mask, _group_key_valid(left_keys, pb))
        lo = jnp.searchsorted(sorted_keys, keys, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(sorted_keys, keys, side="right").astype(jnp.int32)
        lo = jnp.minimum(lo, n_build)
        hi = jnp.minimum(hi, n_build)
        counts = jnp.where(kmask, hi - lo, 0).astype(jnp.int32)
        if how == "left":
            out_counts = jnp.maximum(counts, mask.astype(jnp.int32))
        else:
            out_counts = counts
        total = jnp.sum(out_counts, dtype=jnp.int64)
        lbytes, rbytes, kbytes = _emit_byte_totals(pb, build, on, how, lo,
                                                   counts, out_counts)
        return lo, counts, out_counts, total, lbytes, rbytes, kbytes

    return step


def _emit_vcaps(lbytes: dict, rbytes: dict, kbytes) -> tuple:
    """Static (hashable) capacity spec for the emit kernel."""
    lcaps = tuple(sorted((i, bucket_capacity(max(int(b), 1)))
                         for i, b in lbytes.items()))
    rcaps = tuple(sorted((i, bucket_capacity(max(int(b), 1)))
                         for i, b in rbytes.items()))
    kcaps = tuple((bucket_capacity(max(int(kb), 1)),
                   bucket_capacity(max(int(rb), 1))) for kb, rb in kbytes)
    return (lcaps, rcaps, kcaps)


@functools.cache
def _jit_emit(out_schema: Schema, how: str, out_cap: int, on: tuple,
              filter_expr, vcaps: tuple = ((), (), ())):
    lcaps, rcaps, kcaps = dict(vcaps[0]), dict(vcaps[1]), vcaps[2]

    @jax.jit
    def step(pb: Batch, build: Batch, lo, counts, out_counts):
        rid, intra, total = layout_ops.expand_segments(out_counts, out_cap)
        ocount = jnp.minimum(total, out_cap)
        live_out = jnp.arange(out_cap, dtype=jnp.int32) < ocount
        probe_idx = rid
        has_match = counts[rid] > 0
        build_idx = jnp.clip(lo[rid] + intra, 0, build.capacity - 1)

        left_taken = layout_ops.take_batch(pb, probe_idx, ocount,
                                           out_vcaps=lcaps)
        right_taken = layout_ops.take_batch(build, build_idx, ocount,
                                            out_vcaps=rcaps)
        # raw join output (right side not yet null-extended): the residual
        # filter must see real match values, never nulled ones
        raw = Batch(out_schema,
                    list(left_taken.columns) + list(right_taken.columns),
                    ocount)
        # exact-match verification for hashed (string) keys
        keq = jnp.ones(out_cap, dtype=bool)
        for li, (le, re) in enumerate(on):
            lv = eval_expr(le, pb)
            if isinstance(lv, VarColumn):
                kc = kcaps[li] if li < len(kcaps) else (None, None)
                lcol = layout_ops.take_var(lv, probe_idx, ocount,
                                           out_vcap=kc[0])
                rv = eval_expr(re, build)
                if isinstance(rv, DictColumn):
                    rv = layout_ops.dict_to_var(rv)
                rcol = layout_ops.take_var(rv, build_idx, ocount,
                                           out_vcap=kc[1])
                from .expressions import _string_col_eq

                keq = jnp.logical_and(keq, _string_col_eq(lcol, rcol))
        fm = jnp.ones(out_cap, dtype=bool) if filter_expr is None else \
            as_bool_mask(eval_expr(filter_expr, raw), raw)
        if how == "left":
            # a match survives only if the keys verify AND the ON filter
            # passes; probe rows with NO surviving match keep one
            # null-extended row (their first emitted slot)
            match_ok = jnp.logical_and(
                jnp.logical_and(keq, fm),
                jnp.logical_and(has_match, live_out))
            surv = jnp.zeros(pb.capacity, dtype=bool).at[probe_idx].max(
                match_ok)
            rescue = jnp.logical_and(
                intra == 0, jnp.logical_not(surv[probe_idx]))
            rescue = jnp.logical_and(
                rescue, jnp.logical_and(pb.row_mask()[probe_idx], live_out))
            cols = list(left_taken.columns) + \
                [_null_where(c, rescue) for c in right_taken.columns]
            out = Batch(out_schema, cols, ocount)
            return layout_ops.filter_batch(
                out, jnp.logical_or(match_ok, rescue))
        ok = jnp.logical_and(jnp.logical_and(keq, fm), live_out)
        return layout_ops.filter_batch(raw, ok)

    return step


def _null_where(col, null_mask):
    if isinstance(col, FixedColumn):
        return FixedColumn(col.values, jnp.logical_and(col.validity,
                                                       jnp.logical_not(null_mask)))
    if isinstance(col, DictColumn):
        return DictColumn(col.codes, jnp.logical_and(col.validity,
                                                     jnp.logical_not(null_mask)),
                          col.vocab)
    if isinstance(col, VarColumn):
        return VarColumn(col.values, col.offsets,
                         jnp.logical_and(col.validity, jnp.logical_not(null_mask)))
    return col
