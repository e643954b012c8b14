"""Logical data types and schemas for exon-tpu device batches.

Mirrors the schema surface of the reference engine (Arrow types used by
wheretrue/exon, see exon-common/src/table_schema.rs:22-115) but is designed
for a device columnar layout: every logical type maps onto fixed-shape
device buffers (values / offsets / validity) so that XLA sees static shapes.

This module is pure host-side metadata; no jax imports.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class TypeKind(enum.Enum):
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT32 = "uint32"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    # Variable-width UTF-8 / binary, stored as flat uint8 values + int32 offsets.
    UTF8 = "utf8"
    LARGE_UTF8 = "large_utf8"
    BINARY = "binary"
    # Nested
    LIST = "list"
    STRUCT = "struct"
    # Dictionary-encoded utf8: int32 codes + host-side vocabulary. This is the
    # device representation for low-cardinality string columns (chromosome
    # names, feature types, filters) — group-by and joins on these become
    # integer ops on the device instead of string compares.
    DICTIONARY = "dictionary"
    MAP = "map"  # represented as list<struct<key,value>>


_FIXED_WIDTH = {
    TypeKind.INT8,
    TypeKind.INT16,
    TypeKind.INT32,
    TypeKind.INT64,
    TypeKind.UINT8,
    TypeKind.UINT32,
    TypeKind.FLOAT32,
    TypeKind.FLOAT64,
    TypeKind.BOOL,
}

_VAR_WIDTH = {TypeKind.UTF8, TypeKind.LARGE_UTF8, TypeKind.BINARY}


@dataclass(frozen=True)
class DataType:
    kind: TypeKind
    # For LIST: the element type. For DICTIONARY: the value type (utf8).
    value_type: Optional["DataType"] = None
    # For STRUCT / MAP: child fields.
    children: tuple["Field", ...] = ()

    @property
    def is_fixed_width(self) -> bool:
        return self.kind in _FIXED_WIDTH

    @property
    def is_var_width(self) -> bool:
        return self.kind in _VAR_WIDTH

    @property
    def is_nested(self) -> bool:
        return self.kind in (TypeKind.LIST, TypeKind.STRUCT, TypeKind.MAP)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        if self.kind == TypeKind.LIST:
            return f"list<{self.value_type}>"
        if self.kind == TypeKind.STRUCT:
            inner = ", ".join(f"{f.name}: {f.dtype}" for f in self.children)
            return f"struct<{inner}>"
        if self.kind == TypeKind.DICTIONARY:
            return "dict<utf8>"
        return self.kind.value


# Convenience singletons
int8 = DataType(TypeKind.INT8)
int16 = DataType(TypeKind.INT16)
int32 = DataType(TypeKind.INT32)
int64 = DataType(TypeKind.INT64)
uint8 = DataType(TypeKind.UINT8)
uint32 = DataType(TypeKind.UINT32)
float32 = DataType(TypeKind.FLOAT32)
float64 = DataType(TypeKind.FLOAT64)
bool_ = DataType(TypeKind.BOOL)
utf8 = DataType(TypeKind.UTF8)
large_utf8 = DataType(TypeKind.LARGE_UTF8)
binary = DataType(TypeKind.BINARY)
dictionary = DataType(TypeKind.DICTIONARY, value_type=utf8)


def list_(value_type: DataType) -> DataType:
    return DataType(TypeKind.LIST, value_type=value_type)


def struct(fields: list["Field"]) -> DataType:
    return DataType(TypeKind.STRUCT, children=tuple(fields))


def map_(key: DataType, value: DataType) -> DataType:
    kv = struct([Field("key", key), Field("value", value)])
    return DataType(TypeKind.MAP, value_type=kv)


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __str__(self) -> str:  # pragma: no cover
        return f"{self.name}: {self.dtype}"


@dataclass(frozen=True)
class Schema:
    """Ordered collection of fields.

    `partition_fields` mirrors the reference's TableSchema split between fields
    present in the file vs hive partition columns
    (exon-common/src/table_schema.rs:22-115).
    """

    fields: tuple[Field, ...]
    partition_fields: tuple[Field, ...] = ()

    @staticmethod
    def of(*fields: Field) -> "Schema":
        return Schema(tuple(fields))

    @property
    def all_fields(self) -> tuple[Field, ...]:
        return self.fields + self.partition_fields

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.all_fields]

    def field(self, name: str) -> Field:
        for f in self.all_fields:
            if f.name == name:
                return f
        raise KeyError(f"no field named {name!r}; have {self.names}")

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.all_fields):
            if f.name == name:
                return i
        raise KeyError(f"no field named {name!r}; have {self.names}")

    def has_field(self, name: str) -> bool:
        return any(f.name == name for f in self.all_fields)

    def project(self, names: list[str]) -> "Schema":
        by_name = {f.name: f for f in self.all_fields}
        return Schema(tuple(by_name[n] for n in names))

    def with_partition_fields(self, fields: list[Field]) -> "Schema":
        return Schema(self.fields, tuple(fields))

    def __len__(self) -> int:
        return len(self.all_fields)

    def __iter__(self):
        return iter(self.all_fields)

    def __str__(self) -> str:  # pragma: no cover
        return "Schema(" + ", ".join(str(f) for f in self.all_fields) + ")"


def numpy_dtype(dtype: DataType):
    import numpy as np

    return {
        TypeKind.INT8: np.int8,
        TypeKind.INT16: np.int16,
        TypeKind.INT32: np.int32,
        TypeKind.INT64: np.int64,
        TypeKind.UINT8: np.uint8,
        TypeKind.UINT32: np.uint32,
        TypeKind.FLOAT32: np.float32,
        TypeKind.FLOAT64: np.float64,
        TypeKind.BOOL: np.bool_,
    }[dtype.kind]
