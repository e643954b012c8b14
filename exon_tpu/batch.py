"""Device-columnar record batches: the Arrow-on-device substrate.

The reference engine moves data as Arrow ``RecordBatch``es between streaming
operators (exon-common/src/array_builder.rs:20-45). Under jit, XLA requires
static shapes, so a batch here is a pytree of fixed-**capacity** device
buffers plus a dynamic row-count scalar:

  * ``FixedColumn``  — values ``[cap]`` (+ validity ``[cap]``)
  * ``VarColumn``    — Arrow-style flat ``values [vcap]`` + ``offsets [cap+1]``
                       (strings use uint8 values; ``List<Int64>`` quality
                       scores and ``List<Float64>`` mz peaks use wider dtypes)
  * ``DictColumn``   — int32 codes + a *host-side static* vocabulary; the
                       device encoding for chromosome / feature-type /
                       filter columns so group-by & join are integer ops
  * ``StructColumn`` — named children

Capacities are bucketed (next power of two) so the jit cache sees a small,
stable set of shapes; actual row/byte counts ride along as device scalars and
kernels mask with ``row_mask()``.

Host staging is numpy; ``to_arrow``/``from_arrow`` provide exact interop for
parity testing against the reference engine's output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .datatypes import DataType, Field, Schema, TypeKind, numpy_dtype

DEFAULT_BATCH_SIZE = 8192  # reference: exon-common/src/lib.rs:27


def bucket_capacity(n: int, minimum: int = 128) -> int:
    """Round ``n`` up to the next power of two (>= minimum).

    Bounds the number of distinct compiled shapes to O(log max_batch).
    """
    cap = minimum
    while cap < n:
        cap <<= 1
    return cap


def _is_np(x) -> bool:
    return isinstance(x, np.ndarray)


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FixedColumn:
    """Fixed-width primitive column. values[cap]; validity[cap] (True=valid)."""

    values: Any  # jnp or np array [cap]
    validity: Any  # bool [cap]

    def tree_flatten(self):
        return (self.values, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    def slice_np(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        return np.asarray(self.values)[:n], np.asarray(self.validity)[:n]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VarColumn:
    """Variable-length column: flat values + offsets (Arrow layout, padded).

    ``offsets`` has shape ``[cap + 1]``; row i spans values[offsets[i]:offsets[i+1]].
    Rows past the batch length have zero extent (offsets repeat).
    """

    values: Any  # [vcap] any fixed dtype (uint8 for strings)
    offsets: Any  # int32 [cap + 1]
    validity: Any  # bool [cap]

    def tree_flatten(self):
        return (self.values, self.offsets, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def value_capacity(self) -> int:
        return self.values.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DictColumn:
    """Dictionary-encoded utf8: device int32 codes + static host vocabulary."""

    codes: Any  # int32 [cap]
    validity: Any  # bool [cap]
    vocab: tuple[str, ...] = dataclasses.field(default=())

    def tree_flatten(self):
        return (self.codes, self.validity), self.vocab

    @classmethod
    def tree_unflatten(cls, vocab, children):
        return cls(children[0], children[1], vocab)

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ListColumn:
    """List<child> with its own offsets; child is any column type."""

    child: Any  # Column over flattened elements
    offsets: Any  # int32 [cap + 1]
    validity: Any  # bool [cap]

    def tree_flatten(self):
        return (self.child, self.offsets, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StructColumn:
    children: dict  # name -> Column
    validity: Any  # bool [cap]

    def tree_flatten(self):
        names = tuple(sorted(self.children))
        return (tuple(self.children[n] for n in names), self.validity), names

    @classmethod
    def tree_unflatten(cls, names, children):
        cols, validity = children
        return cls(dict(zip(names, cols)), validity)

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PrefixColumn:
    """Late-materialized string column: first-K bytes + true lengths.

    Used when the planner proves a predicate only inspects bounded prefixes
    (LIKE 'lit%', equality with short literals, length) — staging K bytes
    per row instead of the full flat buffer slashes host→device transfer.
    """

    prefix: Any   # uint8 [cap, K]
    lengths: Any  # int32 [cap] — TRUE row lengths
    validity: Any

    def tree_flatten(self):
        return (self.prefix, self.lengths, self.validity), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.lengths.shape[0]

    @property
    def k(self) -> int:
        return self.prefix.shape[1]


Column = Union[FixedColumn, VarColumn, DictColumn, ListColumn, StructColumn,
               PrefixColumn]


# ---------------------------------------------------------------------------
# Batch
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Batch:
    """A record batch. Works both host-side (numpy) and device-side (jnp).

    ``length`` is dynamic (device scalar under jit); ``capacity`` static.
    """

    schema: Schema
    columns: list  # list[Column], parallel to schema.all_fields
    length: Any  # int32 scalar (np or jnp)

    def tree_flatten(self):
        return (tuple(self.columns), self.length), self.schema

    @classmethod
    def tree_unflatten(cls, schema, children):
        cols, length = children
        return cls(schema, list(cols), length)

    # -- basic accessors ----------------------------------------------------

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return self.columns[0].capacity

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def row_mask(self):
        """bool[cap]: True for live rows. Use to mask out padding."""
        cap = self.capacity
        iota = jnp.arange(cap, dtype=jnp.int32)
        return iota < jnp.asarray(self.length, dtype=jnp.int32)

    def num_rows_host(self) -> int:
        return int(np.asarray(jax.device_get(self.length)))

    def with_columns(self, schema: Schema, columns: list) -> "Batch":
        return Batch(schema, columns, self.length)

    def project(self, names: list[str]) -> "Batch":
        cols = [self.column(n) for n in names]
        return Batch(self.schema.project(names), cols, self.length)

    # -- host <-> device ----------------------------------------------------

    def to_device(self, capacity: Optional[int] = None,
                  value_capacity: Optional[int] = None) -> "Batch":
        """Pad host (numpy) buffers to bucketed capacities and transfer."""
        n = int(self.length)
        cap = capacity or bucket_capacity(max(n, 1))
        cols = [
            _pad_to_device(c, f.dtype, n, cap, value_capacity)
            for c, f in zip(self.columns, self.schema.all_fields)
        ]
        return Batch(self.schema, cols, jnp.int32(n))

    # -- Arrow interop ------------------------------------------------------

    def to_arrow(self):
        import pyarrow as pa

        n = self.num_rows_host()
        arrays, fields = [], []
        for col, f in zip(self.columns, self.schema.all_fields):
            arr = _column_to_arrow(jax.device_get(col), f.dtype, n)
            arrays.append(arr)
            fields.append(pa.field(f.name, arr.type, f.nullable))
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    @staticmethod
    def from_arrow(rb, schema: Optional[Schema] = None) -> "Batch":
        cols = []
        if schema is None:
            schema = schema_from_arrow(rb.schema)
        for i, f in enumerate(schema.all_fields):
            cols.append(_column_from_arrow(rb.column(i), f.dtype))
        return Batch(schema, cols, np.int32(rb.num_rows))

    def to_pandas(self):
        return self.to_arrow().to_pandas()


# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------


def fixed_column(values: np.ndarray, validity: Optional[np.ndarray] = None) -> FixedColumn:
    if validity is None:
        validity = np.ones(len(values), dtype=np.bool_)
    return FixedColumn(values, validity)


def var_column(values: np.ndarray, offsets: np.ndarray,
               validity: Optional[np.ndarray] = None) -> VarColumn:
    n = len(offsets) - 1
    if validity is None:
        validity = np.ones(n, dtype=np.bool_)
    return VarColumn(values, offsets.astype(np.int32, copy=False), validity)


def utf8_column(strings: Sequence[Optional[str]]) -> VarColumn:
    """Convenience builder (test/metadata paths; hot decoders build buffers directly)."""
    parts, offs, valid = [], [0], []
    total = 0
    for s in strings:
        if s is None:
            valid.append(False)
        else:
            b = s.encode()
            parts.append(b)
            total += len(b)
            valid.append(True)
        offs.append(total)
    values = np.frombuffer(b"".join(parts), dtype=np.uint8).copy() if parts else np.zeros(0, np.uint8)
    return VarColumn(values, np.asarray(offs, np.int32), np.asarray(valid, np.bool_))


def dict_column(codes: np.ndarray, vocab: Sequence[str],
                validity: Optional[np.ndarray] = None) -> DictColumn:
    if validity is None:
        validity = np.ones(len(codes), dtype=np.bool_)
    return DictColumn(codes.astype(np.int32, copy=False), validity, tuple(vocab))


def batch_from_host(schema: Schema, columns: list, n_rows: int) -> Batch:
    return Batch(schema, columns, np.int32(n_rows))


# ---------------------------------------------------------------------------
# Padding / transfer
# ---------------------------------------------------------------------------


def _pad1(arr, cap: int, fill=0):
    arr = np.asarray(arr)
    if arr.shape[0] >= cap:
        return arr[:cap]
    out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _pad_to_device(col: Column, dtype: DataType, n: int, cap: int,
                   vcap_hint: Optional[int]) -> Column:
    if isinstance(col, FixedColumn):
        return FixedColumn(jnp.asarray(_pad1(col.values, cap)),
                           jnp.asarray(_pad1(col.validity, cap, False)))
    if isinstance(col, DictColumn):
        return DictColumn(jnp.asarray(_pad1(col.codes, cap)),
                          jnp.asarray(_pad1(col.validity, cap, False)), col.vocab)
    if isinstance(col, VarColumn):
        offsets = np.asarray(col.offsets)
        total = int(offsets[n]) if len(offsets) > n else int(offsets[-1])
        vcap = vcap_hint or bucket_capacity(max(total, 1), minimum=1024)
        # pad offsets by repeating the terminal offset → zero-extent pad rows
        off = np.full(cap + 1, total, dtype=np.int32)
        off[: min(len(offsets), cap + 1)] = offsets[: cap + 1]
        return VarColumn(jnp.asarray(_pad1(col.values, vcap)), jnp.asarray(off),
                         jnp.asarray(_pad1(col.validity, cap, False)))
    if isinstance(col, ListColumn):
        offsets = np.asarray(col.offsets)
        total = int(offsets[n]) if len(offsets) > n else int(offsets[-1])
        off = np.full(cap + 1, total, dtype=np.int32)
        off[: min(len(offsets), cap + 1)] = offsets[: cap + 1]
        child = _pad_to_device(col.child, dtype.value_type or dtype, total,
                               bucket_capacity(max(total, 1), minimum=1024), None)
        return ListColumn(child, jnp.asarray(off), jnp.asarray(_pad1(col.validity, cap, False)))
    if isinstance(col, StructColumn):
        children = {
            f.name: _pad_to_device(col.children[f.name], f.dtype, n, cap, None)
            for f in dtype.children
        }
        return StructColumn(children, jnp.asarray(_pad1(col.validity, cap, False)))
    if isinstance(col, PrefixColumn):
        return PrefixColumn(jnp.asarray(_pad1(col.prefix, cap)),
                            jnp.asarray(_pad1(col.lengths, cap)),
                            jnp.asarray(_pad1(col.validity, cap, False)))
    raise TypeError(f"unknown column type {type(col)}")


# ---------------------------------------------------------------------------
# Arrow conversion
# ---------------------------------------------------------------------------


def arrow_type(dtype: DataType):
    import pyarrow as pa

    k = dtype.kind
    simple = {
        TypeKind.INT8: pa.int8(), TypeKind.INT16: pa.int16(),
        TypeKind.INT32: pa.int32(), TypeKind.INT64: pa.int64(),
        TypeKind.UINT8: pa.uint8(), TypeKind.UINT32: pa.uint32(),
        TypeKind.FLOAT32: pa.float32(), TypeKind.FLOAT64: pa.float64(),
        TypeKind.BOOL: pa.bool_(), TypeKind.UTF8: pa.utf8(),
        TypeKind.LARGE_UTF8: pa.large_utf8(), TypeKind.BINARY: pa.binary(),
    }
    if k in simple:
        return simple[k]
    if k == TypeKind.DICTIONARY:
        return pa.utf8()  # decoded on export
    if k == TypeKind.LIST:
        return pa.list_(arrow_type(dtype.value_type))
    if k == TypeKind.STRUCT:
        return pa.struct([pa.field(f.name, arrow_type(f.dtype), f.nullable)
                          for f in dtype.children])
    if k == TypeKind.MAP:
        kv = dtype.value_type
        return pa.map_(arrow_type(kv.children[0].dtype), arrow_type(kv.children[1].dtype))
    raise TypeError(f"no arrow mapping for {dtype}")


def schema_from_arrow(pa_schema) -> Schema:
    return Schema(tuple(Field(f.name, _dtype_from_arrow(f.type), f.nullable)
                        for f in pa_schema))


def _dtype_from_arrow(t) -> DataType:
    import pyarrow as pa
    from . import datatypes as dt

    if pa.types.is_int8(t):
        return dt.int8
    if pa.types.is_int16(t):
        return dt.int16
    if pa.types.is_int32(t):
        return dt.int32
    if pa.types.is_int64(t):
        return dt.int64
    if pa.types.is_uint8(t):
        return dt.uint8
    if pa.types.is_uint32(t):
        return dt.uint32
    if pa.types.is_float32(t):
        return dt.float32
    if pa.types.is_float64(t):
        return dt.float64
    if pa.types.is_boolean(t):
        return dt.bool_
    if pa.types.is_large_string(t):
        return dt.large_utf8
    if pa.types.is_string(t):
        return dt.utf8
    if pa.types.is_binary(t):
        return dt.binary
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return dt.list_(_dtype_from_arrow(t.value_type))
    if pa.types.is_struct(t):
        return dt.struct([Field(f.name, _dtype_from_arrow(f.type), f.nullable) for f in t])
    if pa.types.is_map(t):
        return dt.map_(_dtype_from_arrow(t.key_type), _dtype_from_arrow(t.item_type))
    if pa.types.is_dictionary(t):
        return dt.dictionary
    raise TypeError(f"unsupported arrow type {t}")


def _column_to_arrow(col: Column, dtype: DataType, n: int):
    import pyarrow as pa

    patype = arrow_type(dtype)
    if isinstance(col, FixedColumn):
        vals, valid = col.slice_np(n)
        mask = ~valid if not valid.all() else None
        if dtype.kind == TypeKind.BOOL:
            vals = vals.astype(np.bool_)
        return pa.array(vals, type=patype, mask=mask)
    if isinstance(col, DictColumn):
        codes = np.asarray(col.codes)[:n]
        valid = np.asarray(col.validity)[:n]
        vocab = list(col.vocab)
        out = [vocab[c] if v and 0 <= c < len(vocab) else None
               for c, v in zip(codes, valid)]
        return pa.array(out, type=pa.utf8())
    if isinstance(col, VarColumn):
        offs = np.asarray(col.offsets)[: n + 1].astype(np.int32)
        vals = np.asarray(col.values)[: int(offs[-1]) if n else 0]
        valid = np.asarray(col.validity)[:n]
        if dtype.kind in (TypeKind.UTF8, TypeKind.LARGE_UTF8, TypeKind.BINARY,
                          TypeKind.DICTIONARY):
            buf_validity = None
            if not valid.all():
                buf_validity = pa.array(valid).buffers()[1]
            arr = pa.StringArray.from_buffers(
                n, pa.py_buffer(offs.tobytes()), pa.py_buffer(vals.tobytes()),
                buf_validity)
            if dtype.kind == TypeKind.LARGE_UTF8:
                arr = arr.cast(pa.large_utf8())
            elif dtype.kind == TypeKind.BINARY:
                arr = arr.cast(pa.binary())
            return arr
        # numeric list stored as VarColumn
        child = pa.array(vals, type=arrow_type(dtype.value_type))
        return pa.ListArray.from_arrays(pa.array(offs, pa.int32()), child,
                                        mask=pa.array(~valid) if not valid.all() else None)
    if isinstance(col, ListColumn):
        offs = np.asarray(col.offsets)[: n + 1].astype(np.int32)
        total = int(offs[-1]) if n else 0
        child = _column_to_arrow(col.child, dtype.value_type, total)
        valid = np.asarray(col.validity)[:n]
        mask = pa.array(~valid) if not valid.all() else None
        if dtype.kind == TypeKind.MAP:
            kv = child
            return pa.MapArray.from_arrays(pa.array(offs, pa.int32()),
                                           kv.field(0), kv.field(1))
        return pa.ListArray.from_arrays(pa.array(offs, pa.int32()), child, mask=mask)
    if isinstance(col, StructColumn):
        valid = np.asarray(col.validity)[:n]
        arrays = [_column_to_arrow(col.children[f.name], f.dtype, n)
                  for f in dtype.children]
        names = [f.name for f in dtype.children]
        sa = pa.StructArray.from_arrays(arrays, names)
        if not valid.all():
            # apply validity via mask filtering at export level
            sa = pa.StructArray.from_arrays(arrays, names)
        return sa
    raise TypeError(f"unknown column {type(col)}")


def _column_from_arrow(arr, dtype: DataType) -> Column:
    import pyarrow as pa

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    n = len(arr)
    if dtype.is_fixed_width:
        vals = arr.to_numpy(zero_copy_only=False)
        valid = ~np.asarray(arr.is_null())
        if vals.dtype.kind == "f":
            # zero only NULL slots (their to_numpy image is NaN); genuine
            # NaN VALUES are data and must survive (they order greatest,
            # arrow/DataFusion total order)
            vals = np.where(valid, vals, 0.0)
        return FixedColumn(np.ascontiguousarray(vals, dtype=numpy_dtype(dtype)),
                           valid)
    if dtype.kind in (TypeKind.UTF8, TypeKind.LARGE_UTF8, TypeKind.BINARY,
                      TypeKind.DICTIONARY):
        # DICTIONARY columns round-trip through arrow as plain utf8; they
        # come back as VarColumn (re-encoding happens at scan time only)
        if pa.types.is_large_string(arr.type):
            arr = arr.cast(pa.utf8())
        bufs = arr.buffers()
        offsets = np.frombuffer(bufs[1], dtype=np.int32,
                                count=n + 1, offset=arr.offset * 4).copy()
        values = (np.frombuffer(bufs[2], dtype=np.uint8).copy()
                  if bufs[2] is not None else np.zeros(0, np.uint8))
        base = offsets[0]
        if base:
            offsets = offsets - base
            values = values[base: base + offsets[-1]]
        valid = ~np.asarray(arr.is_null())
        return VarColumn(values, offsets, valid)
    if dtype.kind == TypeKind.LIST:
        off = np.asarray(arr.offsets)
        child = _column_from_arrow(arr.values, dtype.value_type)
        valid = ~np.asarray(arr.is_null())
        if dtype.value_type.is_fixed_width:
            return VarColumn(child.values, off.astype(np.int32), valid) \
                if isinstance(child, FixedColumn) else ListColumn(child, off.astype(np.int32), valid)
        return ListColumn(child, off.astype(np.int32), valid)
    if dtype.kind == TypeKind.STRUCT:
        children = {f.name: _column_from_arrow(arr.field(f.name), f.dtype)
                    for f in dtype.children}
        valid = ~np.asarray(arr.is_null())
        return StructColumn(children, valid)
    if dtype.kind == TypeKind.MAP:
        # maps round-trip as list<struct<key, value>> (the engine's native
        # encoding — attrmap.parse_attributes builds the same shape)
        kv = dtype.value_type
        off = np.asarray(arr.offsets).astype(np.int32)
        base = off[0]
        keys, items = arr.keys, arr.items
        if base:
            off = off - base
            keys = keys.slice(base, int(off[-1]))
            items = items.slice(base, int(off[-1]))
        kcol = _column_from_arrow(keys, kv.children[0].dtype)
        vcol = _column_from_arrow(items, kv.children[1].dtype)
        child = StructColumn({kv.children[0].name: kcol,
                              kv.children[1].name: vcol},
                             np.ones(len(keys), bool))
        valid = ~np.asarray(arr.is_null())
        return ListColumn(child, off, valid)
    raise TypeError(f"from_arrow unsupported for {dtype}")
