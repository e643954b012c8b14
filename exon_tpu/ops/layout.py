"""Core columnar layout kernels: row-id maps, gather/compaction, expansion.

These are the building blocks every relational operator uses:

  * ``byte_row_ids``   — flat value position → row id (scatter+cumsum, O(vcap))
  * ``take_*``         — gather rows by index (filter materialization, sort
                         reorder, join output); var-width take re-lays flat
                         buffers with pure vectorized gathers
  * ``expand_segments``— repeat row i count[i] times (join multiplicity)

All are shape-static and fuse under jit; the flat-buffer design keeps them
streaming ops bound by memory bandwidth (no scalar loops, no dynamic shapes).

Replaces the role of Arrow compute's take/filter kernels used throughout the
reference engine's DataFusion operators.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..batch import (Batch, Column, DictColumn, FixedColumn, ListColumn,
                     PrefixColumn, StructColumn, VarColumn)


def byte_row_ids(offsets: jnp.ndarray, vcap: int) -> jnp.ndarray:
    """Map each flat value position to its row id.

    offsets: int32[cap+1] (monotone; padded rows repeat the terminal offset).
    Returns int32[vcap]; positions beyond the last offset map to the last row
    index present (callers mask with live-byte masks).
    """
    cap = offsets.shape[0] - 1
    starts = offsets[1:]  # row i ends at offsets[i+1]
    ones = jnp.zeros(vcap + 1, dtype=jnp.int32).at[
        jnp.clip(starts, 0, vcap)].add(1, indices_are_sorted=True)
    return jnp.cumsum(ones[:vcap], dtype=jnp.int32)


def live_byte_mask(offsets: jnp.ndarray, length: jnp.ndarray, vcap: int) -> jnp.ndarray:
    """bool[vcap]: True for value positions belonging to live rows."""
    end = offsets[jnp.asarray(length, jnp.int32)]
    return jnp.arange(vcap, dtype=jnp.int32) < end


def row_lengths(offsets: jnp.ndarray) -> jnp.ndarray:
    return offsets[1:] - offsets[:-1]


def first_bytes(col: VarColumn, fill: int = 0) -> jnp.ndarray:
    """values[offsets[i]] per row (fill for empty rows)."""
    starts = col.offsets[:-1]
    lens = row_lengths(col.offsets)
    idx = jnp.clip(starts, 0, col.value_capacity - 1)
    v = col.values[idx]
    return jnp.where(lens > 0, v, jnp.asarray(fill, col.values.dtype))


def gather_prefix(col: VarColumn, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (prefix[cap, k], valid[cap, k]) — first k values of each row."""
    starts = col.offsets[:-1]
    lens = row_lengths(col.offsets)
    pos = starts[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :]
    valid = jnp.arange(k, dtype=jnp.int32)[None, :] < lens[:, None]
    vals = col.values[jnp.clip(pos, 0, col.value_capacity - 1)]
    return jnp.where(valid, vals, 0), valid


# ---------------------------------------------------------------------------
# Selection → indices
# ---------------------------------------------------------------------------


def mask_to_indices(mask: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stable compaction of a bool mask into row indices.

    Returns (indices int32[cap], count int32). Slots past count hold ``cap``
    (an out-of-range sentinel that take kernels treat as padding).
    """
    cap = mask.shape[0]
    (idx,) = jnp.nonzero(mask, size=cap, fill_value=cap)
    return idx.astype(jnp.int32), jnp.sum(mask, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Take (row gather)
# ---------------------------------------------------------------------------


def take_fixed(col: FixedColumn, indices: jnp.ndarray, count: jnp.ndarray) -> FixedColumn:
    cap = col.capacity
    ocap = indices.shape[0]
    safe = jnp.clip(indices, 0, cap - 1)
    live = jnp.arange(ocap, dtype=jnp.int32) < count
    vals = jnp.where(live, col.values[safe], 0)
    valid = jnp.where(live, col.validity[safe], False)
    return FixedColumn(vals, valid)


def take_dict(col: DictColumn, indices: jnp.ndarray, count: jnp.ndarray) -> DictColumn:
    cap = col.capacity
    ocap = indices.shape[0]
    safe = jnp.clip(indices, 0, cap - 1)
    live = jnp.arange(ocap, dtype=jnp.int32) < count
    codes = jnp.where(live, col.codes[safe], 0)
    valid = jnp.where(live, col.validity[safe], False)
    return DictColumn(codes, valid, col.vocab)


def take_offsets(offsets: jnp.ndarray, indices: jnp.ndarray,
                 count: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compute output offsets for a var-width take.

    Returns (new_offsets int32[ocap+1], src_starts int32[ocap], total int32).
    """
    cap = offsets.shape[0] - 1
    ocap = indices.shape[0]
    safe = jnp.clip(indices, 0, cap - 1)
    live = jnp.arange(ocap, dtype=jnp.int32) < count
    lens = jnp.where(live, (offsets[1:] - offsets[:-1])[safe], 0)
    new_off = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(lens, dtype=jnp.int32)])
    src_starts = jnp.where(live, offsets[:-1][safe], 0)
    return new_off, src_starts, new_off[-1]


def relayout_values(values: jnp.ndarray, src_starts: jnp.ndarray,
                    new_offsets: jnp.ndarray, out_vcap: int,
                    sorted_src: bool = False) -> jnp.ndarray:
    """Move flat values into the new layout: one gather per output position.

    For output position p in row r (r = byte_row_ids(new_offsets)):
        out[p] = values[src_starts[r] + (p - new_offsets[r])]

    Pass sorted_src=True when src_starts is non-decreasing (filter-style
    takes) — lets XLA use a sorted gather.
    """
    vcap = values.shape[0]
    rid = byte_row_ids(new_offsets, out_vcap)
    ocap = src_starts.shape[0]
    rid = jnp.clip(rid, 0, ocap - 1)
    delta = jnp.arange(out_vcap, dtype=jnp.int32) - new_offsets.at[rid].get(
        indices_are_sorted=True)
    src = jnp.clip(src_starts.at[rid].get(indices_are_sorted=True) + delta,
                   0, vcap - 1)
    return values.at[src].get(indices_are_sorted=sorted_src)


def take_var(col: VarColumn, indices: jnp.ndarray, count: jnp.ndarray,
             out_vcap: int | None = None, sorted_indices: bool = False) -> VarColumn:
    out_vcap = out_vcap or col.value_capacity
    new_off, src_starts, total = take_offsets(col.offsets, indices, count)
    vals = relayout_values(col.values, src_starts, new_off, out_vcap,
                           sorted_src=sorted_indices)
    live_v = jnp.arange(out_vcap, dtype=jnp.int32) < total
    vals = jnp.where(live_v, vals, 0)
    ocap = indices.shape[0]
    live = jnp.arange(ocap, dtype=jnp.int32) < count
    valid = jnp.where(live, col.validity[jnp.clip(indices, 0, col.capacity - 1)], False)
    return VarColumn(vals, new_off, valid)


def take_column(col: Column, indices: jnp.ndarray, count: jnp.ndarray,
                sorted_indices: bool = False) -> Column:
    if isinstance(col, FixedColumn):
        return take_fixed(col, indices, count)
    if isinstance(col, DictColumn):
        return take_dict(col, indices, count)
    if isinstance(col, VarColumn):
        return take_var(col, indices, count, sorted_indices=sorted_indices)
    if isinstance(col, StructColumn):
        return StructColumn(
            {k: take_column(v, indices, count) for k, v in col.children.items()},
            take_fixed(FixedColumn(col.validity, col.validity), indices, count).values)
    if isinstance(col, ListColumn):
        # Gather list rows: recompute offsets, then take child elements via
        # an element-level index expansion.
        new_off, src_starts, total = take_offsets(col.offsets, indices, count)
        child_cap = _column_capacity(col.child)
        rid = jnp.clip(byte_row_ids(new_off, child_cap), 0, indices.shape[0] - 1)
        delta = jnp.arange(child_cap, dtype=jnp.int32) - new_off[rid]
        src = jnp.clip(src_starts[rid] + delta, 0, child_cap - 1)
        child = take_column(col.child, src, total)
        ocap = indices.shape[0]
        live = jnp.arange(ocap, dtype=jnp.int32) < count
        valid = jnp.where(live, col.validity[jnp.clip(indices, 0, col.capacity - 1)], False)
        return ListColumn(child, new_off, valid)
    if isinstance(col, PrefixColumn):
        ocap = indices.shape[0]
        safe = jnp.clip(indices, 0, col.capacity - 1)
        live = jnp.arange(ocap, dtype=jnp.int32) < count
        return PrefixColumn(col.prefix[safe],
                            jnp.where(live, col.lengths[safe], 0),
                            jnp.where(live, col.validity[safe], False))
    raise TypeError(f"take_column: {type(col)}")


def _column_capacity(col: Column) -> int:
    if isinstance(col, VarColumn):
        return col.value_capacity
    return col.capacity


def take_batch(batch: Batch, indices: jnp.ndarray, count: jnp.ndarray,
               sorted_indices: bool = False,
               out_vcaps: dict | None = None) -> Batch:
    """Row gather over a whole batch. ``out_vcaps`` (column index → byte
    capacity) resizes var-width value buffers — required whenever the gather
    can EXPAND rows (join multiplicity), where the default same-as-input
    capacity would overflow."""
    cols = []
    for i, c in enumerate(batch.columns):
        ov = out_vcaps.get(i) if out_vcaps else None
        if isinstance(c, VarColumn) and ov is not None:
            cols.append(take_var(c, indices, count, out_vcap=ov,
                                 sorted_indices=sorted_indices))
        else:
            cols.append(take_column(c, indices, count, sorted_indices))
    return Batch(batch.schema, cols, count)


def filter_batch(batch: Batch, mask: jnp.ndarray) -> Batch:
    """Materialize rows where mask & live. The fundamental FilterExec kernel."""
    mask = jnp.logical_and(mask, batch.row_mask())
    idx, count = mask_to_indices(mask)
    return take_batch(batch, idx, count, sorted_indices=True)


# ---------------------------------------------------------------------------
# Device concat + dictionary decode (group-by merge / shuffle building blocks)
# ---------------------------------------------------------------------------


def concat_fixed(a: FixedColumn, b: FixedColumn) -> FixedColumn:
    return FixedColumn(jnp.concatenate([a.values, b.values]),
                       jnp.concatenate([a.validity, b.validity]))


def concat_var(a: VarColumn, b: VarColumn) -> VarColumn:
    """Row-concat two var columns on device (shape-static: caps add).

    a's padding rows (zero extent at its terminal offset) stay interleaved;
    callers track liveness with explicit masks, not row contiguity.
    """
    a_end = a.offsets[-1]
    offsets = jnp.concatenate([a.offsets, b.offsets[1:] + a_end])
    out_vcap = a.value_capacity + b.value_capacity
    p = jnp.arange(out_vcap, dtype=jnp.int32)
    av = a.values[jnp.clip(p, 0, a.value_capacity - 1)]
    bv = b.values[jnp.clip(p - a_end, 0, b.value_capacity - 1)]
    values = jnp.where(p >= a_end, bv, av)
    return VarColumn(values, offsets,
                     jnp.concatenate([a.validity, b.validity]))


def concat_column(a: Column, b: Column) -> Column:
    if isinstance(a, FixedColumn) and isinstance(b, FixedColumn):
        return concat_fixed(a, b)
    if isinstance(a, VarColumn) and isinstance(b, VarColumn):
        return concat_var(a, b)
    raise TypeError(f"concat_column: {type(a)} vs {type(b)}")


def concat_device_batches(batches: list[Batch]) -> tuple[Batch, jnp.ndarray]:
    """Fold-concat device batches; returns (batch, live mask over slots)."""
    out = batches[0]
    mask = out.row_mask()
    for b in batches[1:]:
        cols = [concat_column(x, y) for x, y in zip(out.columns, b.columns)]
        mask = jnp.concatenate([mask, b.row_mask()])
        out = Batch(out.schema, cols, out.length + b.length)
    return out, mask


def dict_to_var(col: DictColumn) -> VarColumn:
    """Materialize dictionary codes into a var-width utf8 column on device.

    The vocabulary is host-static, so its flat bytes/offsets are constants;
    the decode is one offsets-cumsum + one relayout gather.
    """
    import numpy as np

    enc = [s.encode() for s in col.vocab] or [b""]
    flat = np.frombuffer(b"".join(enc), np.uint8) if any(enc) else np.zeros(1, np.uint8)
    voff = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=voff[1:])
    table_vals = jnp.asarray(flat if flat.size else np.zeros(1, np.uint8))
    table_off = jnp.asarray(voff)
    maxlen = max((len(e) for e in enc), default=0)
    cap = col.capacity
    codes = jnp.clip(col.codes, 0, len(enc) - 1)
    lens = jnp.where(col.validity, table_off[codes + 1] - table_off[codes], 0)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(lens, dtype=jnp.int32)])
    from ..batch import bucket_capacity

    out_vcap = bucket_capacity(max(cap * max(maxlen, 1), 1))
    vals = relayout_values(table_vals, table_off[codes], offsets, out_vcap)
    live = jnp.arange(out_vcap, dtype=jnp.int32) < offsets[-1]
    return VarColumn(jnp.where(live, vals, 0), offsets, col.validity)


# ---------------------------------------------------------------------------
# Expansion (join multiplicity): repeat row i counts[i] times
# ---------------------------------------------------------------------------


def expand_segments(counts: jnp.ndarray, out_cap: int) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Given per-row repeat counts, build the expanded row-id map.

    Returns (row_ids int32[out_cap], intra int32[out_cap], total int32):
    output slot p maps to source row row_ids[p], occurrence intra[p].
    """
    cap = counts.shape[0]
    ends = jnp.cumsum(counts, dtype=jnp.int32)
    starts = ends - counts
    total = ends[-1] if cap > 0 else jnp.int32(0)
    bump = jnp.zeros(out_cap + 1, dtype=jnp.int32).at[jnp.clip(ends, 0, out_cap)].add(1)
    rid = jnp.cumsum(bump[:out_cap], dtype=jnp.int32)
    rid = jnp.clip(rid, 0, cap - 1)
    intra = jnp.arange(out_cap, dtype=jnp.int32) - starts[rid]
    return rid, intra, total
