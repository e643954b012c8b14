"""Expression trees + device evaluation.

Covers the expression surface the reference engine exposes through DataFusion
(column refs, literals, comparison/boolean/arithmetic ops, LIKE/ILIKE,
BETWEEN, IN, IS NULL, CAST, scalar function calls). Evaluation happens
batch-at-a-time on device: every expression lowers to jnp ops over the
columnar buffers, so a full predicate tree fuses into one XLA computation.

Scalar UDFs (gc_content, reverse_complement, …) are registered in
exon_tpu.udfs and dispatched through ``FunctionCall``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

from .. import datatypes as dt
from ..batch import (Batch, Column, DictColumn, FixedColumn, ListColumn,
                     PrefixColumn, StructColumn, VarColumn)
from ..errors import PlanError
from ..ops import strings as str_ops
from ..ops.layout import row_lengths


class Expr:
    """Base expression node."""

    # -- fluent builders (DataFrame API) -----------------------------------
    def __eq__(self, other):  # type: ignore[override]
        return BinaryOp("=", self, lit(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOp("!=", self, lit(other))

    def __lt__(self, other):
        return BinaryOp("<", self, lit(other))

    def __le__(self, other):
        return BinaryOp("<=", self, lit(other))

    def __gt__(self, other):
        return BinaryOp(">", self, lit(other))

    def __ge__(self, other):
        return BinaryOp(">=", self, lit(other))

    def __and__(self, other):
        return BinaryOp("and", self, lit(other))

    def __or__(self, other):
        return BinaryOp("or", self, lit(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return BinaryOp("+", self, lit(other))

    def __sub__(self, other):
        return BinaryOp("-", self, lit(other))

    def __mul__(self, other):
        return BinaryOp("*", self, lit(other))

    def __truediv__(self, other):
        return BinaryOp("/", self, lit(other))

    def __mod__(self, other):
        return BinaryOp("%", self, lit(other))

    def __hash__(self):
        return hash(repr(self))

    def like(self, pattern: str, escape: "Optional[str]" = None):
        return Like(self, pattern, case_insensitive=False, escape=escape)

    def ilike(self, pattern: str, escape: "Optional[str]" = None):
        return Like(self, pattern, case_insensitive=True, escape=escape)

    def is_null(self):
        return IsNull(self, negated=False)

    def is_not_null(self):
        return IsNull(self, negated=True)

    def isin(self, values: list):
        return InList(self, [lit(v) for v in values])

    def between(self, low, high):
        return BinaryOp("and", BinaryOp(">=", self, lit(low)),
                        BinaryOp("<=", self, lit(high)))

    def alias(self, name: str):
        return Alias(self, name)

    def cast(self, dtype: dt.DataType):
        return Cast(self, dtype)

    def children(self) -> list["Expr"]:
        return []

    def display_name(self) -> str:
        return repr(self)


def lit(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal(v)


def col(name: str) -> "ColumnRef":
    return ColumnRef(name)


@dataclasses.dataclass(repr=True, eq=False)
class ColumnRef(Expr):
    name: str

    def display_name(self) -> str:
        return self.name


@dataclasses.dataclass(eq=False)
class FieldAccess(Expr):
    """Struct-field extraction: ``tags."PG"``. Parsed for every dotted
    identifier; the planner's resolve pass turns table-qualifier dots back
    into plain ColumnRefs against the input schema."""

    child: Expr
    field: str

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return self.field


@dataclasses.dataclass(eq=False)
class Subscript(Expr):
    """``expr[index]`` — map value by string key (DataFusion map access),
    1-based list element by integer, or struct field by string."""

    child: Expr
    index: Expr

    def children(self):
        return [self.child, self.index]

    def display_name(self) -> str:
        return f"{self.child.display_name()}[{self.index.display_name()}]"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    value: Any

    def display_name(self) -> str:
        if isinstance(self.value, str):
            return f"Utf8(\"{self.value}\")"
        return str(self.value)


@dataclasses.dataclass(eq=False)
class Alias(Expr):
    child: Expr
    name: str

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return self.name


@dataclasses.dataclass(eq=False)
class BinaryOp(Expr):
    op: str  # = != < <= > >= and or + - * / %
    left: Expr
    right: Expr

    def children(self):
        return [self.left, self.right]

    def display_name(self) -> str:
        return f"{self.left.display_name()} {self.op} {self.right.display_name()}"


@dataclasses.dataclass(eq=False)
class Not(Expr):
    child: Expr

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class IsNull(Expr):
    child: Expr
    negated: bool

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class Like(Expr):
    child: Expr
    pattern: str
    case_insensitive: bool
    negated: bool = False
    escape: Optional[str] = None  # SQL ESCAPE clause character

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: list
    negated: bool = False

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    child: Expr
    dtype: dt.DataType

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class FunctionCall(Expr):
    name: str
    args: list

    def children(self):
        return list(self.args)

    def display_name(self) -> str:
        return f"{self.name}({', '.join(a.display_name() for a in self.args)})"


@dataclasses.dataclass(eq=False)
class AggregateCall(Expr):
    """count(*) / count(x) / sum / min / max / avg over an optional child."""

    fn: str
    child: Optional[Expr]  # None → count(*)
    distinct: bool = False
    # extra literal arguments (e.g. string_agg separator)
    extra: tuple = ()

    def children(self):
        return [self.child] if self.child is not None else []

    def display_name(self) -> str:
        inner = self.child.display_name() if self.child else "*"
        return f"{self.fn}({inner})"


@dataclasses.dataclass(repr=True, eq=False)
class Case(Expr):
    """CASE [operand] WHEN … THEN … [ELSE …] END.

    The reference gets CASE from DataFusion's expression surface; here the
    whole expression lowers to one jnp.where chain (string results become a
    device DictColumn keyed by branch index — an integer encoding)."""

    operand: Optional[Expr]
    whens: list  # [(when_expr, then_expr)]
    else_: Optional[Expr]

    def children(self):
        out = [self.operand] if self.operand is not None else []
        for w, t in self.whens:
            out.extend([w, t])
        if self.else_ is not None:
            out.append(self.else_)
        return out

    def display_name(self) -> str:
        return "case"


@dataclasses.dataclass(eq=False)
class NullsOrder(Expr):
    """ORDER BY key wrapper carrying an explicit NULLS FIRST/LAST. Key
    builders unwrap it; it is never evaluated as a value."""

    child: Expr
    first: bool

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return (self.child.display_name()
                + (" nulls first" if self.first else " nulls last"))


@dataclasses.dataclass(repr=True, eq=False)
class WindowCall(Expr):
    """fn(...) OVER (PARTITION BY … [ORDER BY …]) — planned into a
    WindowExec breaker, never evaluated directly."""

    fn: str
    child: Optional[Expr]
    partition_by: list
    order_by: list  # [(expr, asc)]
    offset: int = 1      # lag/lead offset; ntile bucket count
    default: object = None
    # frame: None = default (RANGE UNBOUNDED PRECEDING..CURRENT ROW, peers
    # share) or ("rows", lo, hi) with offsets relative to the current row
    # (None = unbounded, negative = preceding, positive = following)
    frame: object = None

    def children(self):
        out = [self.child] if self.child is not None else []
        out.extend(self.partition_by)
        out.extend(e for e, _ in self.order_by)
        return out

    def display_name(self) -> str:
        inner = self.child.display_name() if self.child else ""
        return f"{self.fn}({inner}) over(…)"


@dataclasses.dataclass(repr=True, eq=False)
class Subquery(Expr):
    """Uncorrelated scalar subquery — resolved eagerly by the SQL frontend
    into a Literal before planning."""

    stmt: object  # A.SelectStmt

    def children(self):
        return []

    def display_name(self) -> str:
        return "(subquery)"


@dataclasses.dataclass(repr=True, eq=False)
class ExistsSubquery(Expr):
    stmt: object
    negated: bool = False

    def children(self):
        return []

    def display_name(self) -> str:
        return "exists(subquery)"


@dataclasses.dataclass(repr=True, eq=False)
class InSubquery(Expr):
    child: Expr
    stmt: object
    negated: bool = False

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return "in(subquery)"


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

# value representation during eval: either a Column (Var/Fixed/Dict) or a
# plain jnp array (computed fixed-width values, validity all-true), or a
# python scalar (literal)

ScalarFn = Callable[..., Any]
_FUNCTIONS: dict[str, ScalarFn] = {}
_HOST_FUNCTIONS: set[str] = set()


def register_function(name: str, fn: ScalarFn, host: bool = False) -> None:
    _FUNCTIONS[name.lower()] = fn
    if host:
        _HOST_FUNCTIONS.add(name.lower())


def get_function(name: str) -> Optional[ScalarFn]:
    return _FUNCTIONS.get(name.lower())


def contains_host_fn(expr: "Expr") -> bool:
    """True if the tree calls a host-only UDF (cannot run under jit)."""
    if isinstance(expr, FunctionCall) and expr.name.lower() in _HOST_FUNCTIONS:
        return True
    return any(contains_host_fn(c) for c in expr.children())


def eval_expr(expr: Expr, batch: Batch):
    """Evaluate an expression against a device batch.

    Returns a Column, jnp array ([cap] values), or python scalar.
    """
    if isinstance(expr, Alias):
        return eval_expr(expr.child, batch)
    if isinstance(expr, ColumnRef):
        return batch.column(expr.name)
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, BinaryOp):
        return _eval_binary(expr, batch)
    if isinstance(expr, Not):
        v = as_bool_mask(eval_expr(expr.child, batch), batch)
        return jnp.logical_not(v)
    if isinstance(expr, IsNull):
        v = eval_expr(expr.child, batch)
        nulls = jnp.logical_not(_validity_of(v, batch))
        return jnp.logical_not(nulls) if expr.negated else nulls
    if isinstance(expr, Like):
        v = eval_expr(expr.child, batch)
        if isinstance(v, DictColumn):
            v = _dict_to_mask_like(v, expr)
            return jnp.logical_not(v) if expr.negated else v
        if not isinstance(v, (VarColumn, PrefixColumn)):
            raise PlanError(f"LIKE over non-string value: {expr}")
        m = str_ops.like(v, expr.pattern, expr.case_insensitive, expr.escape)
        return jnp.logical_not(m) if expr.negated else m
    if isinstance(expr, InList):
        v = eval_expr(expr.child, batch)
        vals = [x.value if isinstance(x, Literal) else x for x in expr.values]
        if isinstance(v, DictColumn):
            m = str_ops.dict_isin(v, [str(x) for x in vals])
        elif isinstance(v, VarColumn):
            m = jnp.zeros(v.capacity, bool)
            for x in vals:
                m = jnp.logical_or(m, str_ops.equals_literal(v, str(x).encode()))
        else:
            arr = _as_values(v, batch)
            m = jnp.zeros(arr.shape[0], bool)
            for x in vals:
                m = jnp.logical_or(m, arr == x)
        return jnp.logical_not(m) if expr.negated else m
    if isinstance(expr, Cast):
        v = eval_expr(expr.child, batch)
        return _eval_cast(v, expr.dtype, batch)
    if isinstance(expr, FunctionCall):
        fn = get_function(expr.name)
        if fn is None:
            raise PlanError(f"unknown function {expr.name!r}")
        args = [eval_expr(a, batch) for a in expr.args]
        return fn(batch, *args)
    if isinstance(expr, FieldAccess):
        v = eval_expr(expr.child, batch)
        if isinstance(v, StructColumn):
            child = v.children.get(expr.field)
            if child is None:
                raise PlanError(f"no struct field {expr.field!r}; have "
                                f"{sorted(v.children)}")
            return child
        if isinstance(v, ListColumn) and _is_map_col(v):
            # attributes.ID: map value lookup (DataFusion map access)
            return _map_lookup(v, expr.field)
        raise PlanError(f"field access on non-struct value: {expr!r}")
    if isinstance(expr, Subscript):
        v = eval_expr(expr.child, batch)
        if not isinstance(expr.index, Literal):
            raise PlanError("subscript index must be a literal")
        iv = expr.index.value
        if isinstance(v, StructColumn) and isinstance(iv, str):
            child = v.children.get(iv)
            if child is None:
                raise PlanError(f"no struct field {iv!r}")
            return child
        if isinstance(v, ListColumn):
            if _is_map_col(v) and isinstance(iv, str):
                return _map_lookup(v, iv)
            if isinstance(iv, (int, np.integer)) and not isinstance(iv, bool):
                return _list_element(v, int(iv))
        raise PlanError(
            f"subscript {iv!r} unsupported on {type(v).__name__}")
    if isinstance(expr, Case):
        return _eval_case(expr, batch)
    raise PlanError(f"cannot evaluate {expr!r}")


def _eval_case(expr: Case, batch: Batch):
    """One fused where-chain. String THEN/ELSE literals become a DictColumn
    whose codes select the branch (device-int encoding, no byte shuffling)."""
    conds = []
    for w, _t in expr.whens:
        if expr.operand is not None:
            c = BinaryOp("=", expr.operand, w)
        else:
            c = w
        m = as_bool_mask(eval_expr(c, batch), batch)
        conds.append(m)
    results = [t for _w, t in expr.whens]
    if expr.else_ is not None:
        results.append(expr.else_)

    def is_str_lit(e):
        return isinstance(e, Literal) and (isinstance(e.value, str)
                                           or e.value is None)

    if results and all(is_str_lit(r) for r in results):
        vocab = []
        codes_for = []
        for r in results:
            if r.value is None:
                codes_for.append(-1)
            else:
                if r.value not in vocab:
                    vocab.append(r.value)
                codes_for.append(vocab.index(r.value))
        cap = batch.capacity
        else_code = codes_for[-1] if expr.else_ is not None else -1
        codes = jnp.full(cap, else_code, jnp.int32)
        valid = jnp.full(cap, else_code >= 0)
        taken = jnp.zeros(cap, bool)
        for m, code in zip(conds, codes_for):
            pick = jnp.logical_and(m, jnp.logical_not(taken))
            codes = jnp.where(pick, code, codes)
            valid = jnp.where(pick, code >= 0, valid)
            taken = jnp.logical_or(taken, m)
        return DictColumn(jnp.clip(codes, 0, max(len(vocab) - 1, 0)),
                          jnp.logical_and(valid, batch.row_mask()),
                          tuple(vocab))

    # numeric / boolean path
    cap = batch.capacity
    vals_valid = []
    for r in results:
        v = eval_expr(r, batch)
        if isinstance(v, (VarColumn, DictColumn)):
            raise PlanError("CASE with non-literal string results "
                            "is not supported")
        arr = _as_values(v, batch)
        if not hasattr(arr, "shape") or getattr(arr, "ndim", 0) == 0:
            if isinstance(r, Literal) and r.value is None:
                vals_valid.append((jnp.zeros(cap), jnp.zeros(cap, bool)))
                continue
            arr = jnp.full(cap, arr)
        vals_valid.append((arr, _validity_of(v, batch)))
    if expr.else_ is not None:
        out, valid = vals_valid[-1]
        out = out.astype(jnp.result_type(*[a.dtype for a, _ in vals_valid]))
        branch_vv = vals_valid[:-1]
    else:
        dt_ = jnp.result_type(*[a.dtype for a, _ in vals_valid])
        out = jnp.zeros(cap, dt_)
        valid = jnp.zeros(cap, bool)
        branch_vv = vals_valid
    taken = jnp.zeros(cap, bool)
    for m, (arr, av) in zip(conds, branch_vv):
        pick = jnp.logical_and(m, jnp.logical_not(taken))
        out = jnp.where(pick, arr.astype(out.dtype), out)
        valid = jnp.where(pick, av, valid)
        taken = jnp.logical_or(taken, m)
    return FixedColumn(out, jnp.logical_and(valid, batch.row_mask()))


def _dict_to_mask_like(v: DictColumn, expr: Like) -> jnp.ndarray:
    # evaluate LIKE over the host vocabulary, then map codes
    rx = str_ops.like_regex(expr.pattern, expr.escape, expr.case_insensitive)
    hits = [i for i, s in enumerate(v.vocab) if rx.match(s)]
    m = jnp.zeros(v.capacity, bool)
    for h in hits:
        m = jnp.logical_or(m, v.codes == h)
    return m


def _validity_of(v, batch: Batch):
    if isinstance(v, (FixedColumn, VarColumn, DictColumn, StructColumn)):
        return jnp.asarray(v.validity)
    if isinstance(v, jnp.ndarray) or isinstance(v, np.ndarray):
        return jnp.ones(v.shape[0], bool)
    return jnp.ones(batch.capacity, bool)


def _as_values(v, batch: Batch):
    """Coerce to a jnp array of per-row values (fixed-width path)."""
    if isinstance(v, FixedColumn):
        return jnp.asarray(v.values)
    if isinstance(v, DictColumn):
        return jnp.asarray(v.codes)
    if isinstance(v, (jnp.ndarray, np.ndarray)):
        return jnp.asarray(v)
    if isinstance(v, (int, float, bool)):
        return v
    if isinstance(v, VarColumn):
        raise PlanError("string column used in numeric context")
    raise PlanError(f"cannot coerce {type(v)}")


def as_bool_mask(v, batch: Batch) -> jnp.ndarray:
    if isinstance(v, bool):
        return jnp.full(batch.capacity, v)
    if isinstance(v, FixedColumn):
        return jnp.asarray(v.values).astype(bool) & jnp.asarray(v.validity)
    arr = jnp.asarray(v)
    if arr.dtype != jnp.bool_:
        arr = arr.astype(bool)
    return arr


_CMP = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}

_ARITH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
          "*": lambda a, b: a * b, "/": lambda a, b: a / b,
          "%": lambda a, b: a % b}


def _eval_binary(expr: BinaryOp, batch: Batch):
    op = expr.op
    if op in ("and", "or"):
        lm = as_bool_mask(eval_expr(expr.left, batch), batch)
        rm = as_bool_mask(eval_expr(expr.right, batch), batch)
        return jnp.logical_and(lm, rm) if op == "and" else jnp.logical_or(lm, rm)

    lv = eval_expr(expr.left, batch)
    rv = eval_expr(expr.right, batch)

    if op in _CMP:
        # string comparisons
        lstr = isinstance(lv, (VarColumn, DictColumn, PrefixColumn)) or isinstance(lv, str)
        rstr = isinstance(rv, (VarColumn, DictColumn, PrefixColumn)) or isinstance(rv, str)
        if lstr or rstr:
            return _eval_string_cmp(op, lv, rv, batch)
        a, b = _as_values(lv, batch), _as_values(rv, batch)
        m = _CMP[op](a, b)
        valid = jnp.logical_and(_validity_of(lv, batch), _validity_of(rv, batch))
        return jnp.logical_and(m, valid)
    if op in _ARITH:
        a, b = _as_values(lv, batch), _as_values(rv, batch)
        if op == "/" and not jnp.issubdtype(jnp.result_type(a), jnp.floating) \
                and not jnp.issubdtype(jnp.result_type(b), jnp.floating):
            # SQL integer division truncates
            out = (a / jnp.where(b == 0, 1, b)).astype(jnp.int64)
        elif op == "%":
            # SQL %: sign follows the DIVIDEND (truncated division), not
            # numpy's floored remainder: -7 % 3 = -1, 7 % -3 = 1
            a = jnp.asarray(a)
            b = jnp.asarray(b)
            bz = jnp.where(b == 0, jnp.ones((), b.dtype), b)
            r = jnp.remainder(a, bz)
            flip = jnp.logical_and(r != 0, jnp.sign(a) != jnp.sign(bz))
            out = jnp.where(flip, r - bz, r)
        else:
            out = _ARITH[op](a, b)
        if getattr(out, "ndim", 0) == 0:
            return out  # scalar arithmetic (literal folding)
        # NULL propagation: a NULL operand nulls the result row
        valid = jnp.logical_and(_validity_of(lv, batch),
                                _validity_of(rv, batch))
        return FixedColumn(out, valid)
    raise PlanError(f"unknown operator {op}")


def _eval_string_cmp(op: str, lv, rv, batch: Batch):
    # normalize: column OP literal
    swap = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}
    if isinstance(lv, str):
        lv, rv, op = rv, lv, swap[op]
    if not isinstance(rv, str):
        # column-vs-column string compare (equality only)
        if op in ("=", "!="):
            m = _string_col_eq(lv, rv)
            return jnp.logical_not(m) if op == "!=" else m
        raise PlanError("ordered compare between two string columns unsupported")
    if isinstance(lv, DictColumn):
        if op == "=":
            return str_ops.dict_equals(lv, rv)
        if op == "!=":
            return jnp.logical_and(jnp.logical_not(str_ops.dict_equals(lv, rv)),
                                   jnp.asarray(lv.validity))
        # ordered compare on dict: compare via vocab order lookup
        codes_order = np.argsort(np.argsort([s for s in lv.vocab])) if lv.vocab else np.zeros(0)
        rank = jnp.asarray(codes_order, jnp.int32)[jnp.clip(lv.codes, 0, max(len(lv.vocab) - 1, 0))]
        rv_rank = np.searchsorted(sorted(lv.vocab), rv)
        # approximate: exact for members; boundary semantics for non-members
        return _CMP[op](rank, rv_rank)
    if isinstance(lv, (VarColumn, PrefixColumn)):
        if op == "=":
            return str_ops.equals_literal(lv, rv.encode())
        if op == "!=":
            return jnp.logical_and(
                jnp.logical_not(str_ops.equals_literal(lv, rv.encode())),
                jnp.asarray(lv.validity))
        if isinstance(lv, PrefixColumn):
            raise PlanError("ordered compare needs full strings, not prefixes")
        return _var_cmp_literal(lv, rv.encode(), op)
    raise PlanError(f"string compare over {type(lv)}")


def _is_map_col(v) -> bool:
    return isinstance(v.child, StructColumn) and \
        set(v.child.children) in ({"key", "value"}, {"keys", "values"})


def _mask_validity(col, ok: jnp.ndarray):
    return dataclasses.replace(
        col, validity=jnp.logical_and(jnp.asarray(col.validity), ok))


def _map_lookup(v: ListColumn, key: str):
    """Per-row map value for a string key (NULL when absent) — jittable:
    vectorized key-bytes match over the flat entries + scatter-min to
    find each row's first matching entry, one gather of the value."""
    from ..ops import layout as layout_ops

    kname = "key" if "key" in v.child.children else "keys"
    kcol = v.child.children[kname]
    if isinstance(kcol, DictColumn):
        kcol = layout_ops.dict_to_var(kcol)
    if not isinstance(kcol, VarColumn):
        raise PlanError("map keys must be strings")
    vcol = v.child.children["value" if kname == "key" else "values"]
    match = str_ops.equals_literal(kcol, key.encode())
    n_ent = match.shape[0]
    offs = jnp.asarray(v.offsets).astype(jnp.int32)
    cap = offs.shape[0] - 1
    ent_ids = jnp.arange(n_ent, dtype=jnp.int32)
    live_ent = ent_ids < offs[-1]
    ent_row = jnp.clip(
        jnp.searchsorted(offs, ent_ids, side="right") - 1, 0, cap - 1)
    first = jnp.full(cap, n_ent, jnp.int32).at[ent_row].min(
        jnp.where(jnp.logical_and(match, live_ent), ent_ids, n_ent))
    found = jnp.logical_and(first < n_ent, jnp.asarray(v.validity))
    idx = jnp.clip(first, 0, max(n_ent - 1, 0))
    out = layout_ops.take_column(vcol, idx, jnp.asarray(cap, jnp.int32))
    return _mask_validity(out, found)


def _list_element(v: ListColumn, i: int):
    """1-based list element (DataFusion array indexing); out-of-range or
    non-positive index → NULL."""
    from ..ops import layout as layout_ops

    offs = jnp.asarray(v.offsets).astype(jnp.int32)
    cap = offs.shape[0] - 1
    lens = offs[1:] - offs[:-1]
    ok = jnp.logical_and(jnp.asarray(v.validity),
                         jnp.logical_and(i >= 1, lens >= i))
    n_ent = getattr(v.child, "capacity", None)
    if n_ent is None:
        n_ent = jnp.asarray(v.child.validity).shape[0]
    idx = jnp.clip(offs[:-1] + (i - 1), 0, max(int(n_ent) - 1, 0))
    out = layout_ops.take_column(v.child, idx, jnp.asarray(cap, jnp.int32))
    return _mask_validity(out, ok)


def _string_col_eq(a, b) -> jnp.ndarray:
    if isinstance(a, DictColumn) and isinstance(b, DictColumn) and a.vocab == b.vocab:
        return jnp.logical_and(a.codes == b.codes,
                               jnp.logical_and(a.validity, b.validity))
    if isinstance(a, VarColumn) and isinstance(b, VarColumn):
        from ..ops.layout import gather_prefix as gp

        la, lb = row_lengths(a.offsets), row_lengths(b.offsets)
        k = 32  # compare up to k prefix bytes + length (sufficient for ids/chroms)
        pa, ma = gp(a, k)
        pb, mb = gp(b, k)
        eq = jnp.all(jnp.where(ma | mb, pa == pb, True), axis=1)
        return jnp.logical_and(jnp.logical_and(eq, la == lb),
                               jnp.logical_and(a.validity, b.validity))
    raise PlanError("unsupported string column equality")


def _var_cmp_literal(colv: VarColumn, litb: bytes, op: str) -> jnp.ndarray:
    """Lexicographic compare of a string column against a literal."""
    from ..ops.layout import gather_prefix

    k = max(len(litb), 1)
    pre, valid = gather_prefix(colv, k)
    pat = jnp.asarray(np.frombuffer(litb.ljust(k, b"\0"), dtype=np.uint8))
    # find first differing byte
    diff = jnp.where(valid, pre, 0).astype(jnp.int32) - pat[None, :].astype(jnp.int32)
    nz = diff != 0
    first_nz = jnp.argmax(nz, axis=1)
    any_nz = jnp.any(nz, axis=1)
    d = jnp.take_along_axis(diff, first_nz[:, None], axis=1)[:, 0]
    lens = row_lengths(colv.offsets)
    tie = jnp.where(lens > len(litb), 1, jnp.where(lens < len(litb), -1, 0))
    cmp = jnp.where(any_nz, d, tie)
    return {"<": cmp < 0, "<=": cmp <= 0, ">": cmp > 0, ">=": cmp >= 0}[op]


def _eval_cast(v, dtype: dt.DataType, batch: Batch):
    from ..datatypes import numpy_dtype

    if isinstance(v, str):
        # literal: parse host-side (invalid → typed engine error, like
        # DataFusion's "Cannot cast string ... to value of <T> type")
        if dtype.is_fixed_width:
            npdt = numpy_dtype(dtype)
            try:
                return np.asarray(
                    float(v) if np.issubdtype(npdt, np.floating)
                    else int(v), dtype=npdt).item()
            except ValueError:
                raise PlanError(
                    f"cannot cast string '{v}' to {dtype}") from None
        return v
    if isinstance(v, (int, float, bool)) and dtype.kind in (
            dt.TypeKind.UTF8, dt.TypeKind.LARGE_UTF8):
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)
    if isinstance(v, DictColumn):
        from ..ops.layout import dict_to_var

        v = dict_to_var(v)
    if dtype.is_fixed_width and isinstance(v, VarColumn):
        return _cast_utf8_to_number(v, numpy_dtype(dtype))
    if dtype.kind in (dt.TypeKind.UTF8, dt.TypeKind.LARGE_UTF8):
        if isinstance(v, VarColumn):
            return v
        vals = _as_values(v, batch)
        if jnp.issubdtype(jnp.asarray(vals).dtype, jnp.integer) or \
                jnp.asarray(vals).dtype == jnp.bool_:
            return _cast_int_to_utf8(jnp.asarray(vals).astype(jnp.int64),
                                     _validity_of(v, batch))
        raise PlanError("cast of floats to VARCHAR not supported on device")
    if dtype.is_fixed_width:
        arr = _as_values(v, batch)
        out = jnp.asarray(arr).astype(numpy_dtype(dtype))
        if isinstance(v, (FixedColumn, DictColumn)):
            # casts must carry NULLs through (a bare array would re-mask
            # against row_mask and resurrect null slots as 0)
            return FixedColumn(out, jnp.asarray(v.validity))
        return out
    raise PlanError(f"cast to {dtype} not supported on device")


_POW10_NP = np.asarray([10 ** p for p in range(19)], np.int64)


def _pow10():
    # numpy constant (NOT a cached jnp array: that would capture a tracer
    # when first used under jit and leak it into later traces)
    return jnp.asarray(_POW10_NP)


_POW10F_NP = np.asarray([10.0 ** k for k in range(309)], np.float64)


def _pow10f():
    return jnp.asarray(_POW10F_NP)


def _window(v: VarColumn, W: int):
    """[cap, W] byte window per row (zero beyond row end) + lengths."""
    cap = v.capacity
    offs = jnp.asarray(v.offsets).astype(jnp.int32)
    vals = jnp.asarray(v.values)
    lens = offs[1:] - offs[:-1]
    idx = offs[:-1][:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    win = vals[jnp.clip(idx, 0, max(vals.shape[0] - 1, 0))] \
        if vals.shape[0] else jnp.zeros((cap, W), jnp.uint8)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    in_row = pos < lens[:, None]
    return jnp.where(in_row, win, 0), lens, pos, in_row


def _cast_utf8_to_float(v: VarColumn, npdt) -> FixedColumn:
    """Device parse of utf8 decimal/scientific forms ('3.5', '-1.25e-3',
    '1e3') to float, matching arrow's cast semantics (invalid → NULL).
    Jittable: [cap, 64] byte window; exact for <=18 mantissa digits and
    |decimal exponent| <= 308 (int64 mantissa scaled by an exact float
    power-of-ten table, the classic strtod fast path). Known limit: a
    valid numeral longer than 64 bytes (pathological zero-padding) parses
    as NULL — data-dependent host fallback is impossible under jit."""
    W = 64
    ch, lens, pos, in_row = _window(v, W)
    neg = jnp.logical_and(lens > 0, ch[:, 0] == ord("-"))
    plus = jnp.logical_and(lens > 0, ch[:, 0] == ord("+"))
    sign_skip = jnp.logical_or(neg, plus).astype(jnp.int32)
    digit = (ch - ord("0")).astype(jnp.int32)
    is_digit = jnp.logical_and(digit >= 0, digit <= 9) & in_row
    is_dot = (ch == ord(".")) & in_row
    is_e = (jnp.logical_or(ch == ord("e"), ch == ord("E"))) & in_row
    BIG = jnp.int32(W)
    e_pos = jnp.min(jnp.where(is_e, pos, BIG), axis=1)
    dot_pos = jnp.min(jnp.where(is_dot, pos, BIG), axis=1)
    mant_end = jnp.minimum(e_pos, lens)
    mant_region = (pos >= sign_skip[:, None]) & (pos < mant_end[:, None])
    mant_digit = is_digit & mant_region
    n_mant = jnp.sum(mant_digit, axis=1)
    int_digits = jnp.sum(mant_digit & (pos < dot_pos[:, None]), axis=1)
    frac_digits = n_mant - int_digits
    rank = jnp.cumsum(mant_digit, axis=1) - mant_digit  # exclusive rank
    # exact int64 mantissa over the first 18 SIGNIFICANT digits (leading
    # zeros — '0.000…01' — must not consume the budget); dropped
    # low-order digits shift the decimal exponent instead
    nz = mant_digit & (digit > 0)
    sig_start = jnp.min(jnp.where(nz, rank, jnp.int32(W)), axis=1)
    n_sig = jnp.maximum(n_mant - sig_start, 0)
    n_used = jnp.minimum(n_sig, 18)
    srank = rank - sig_start[:, None]
    use = mant_digit & (srank >= 0) & (srank < 18)
    mpow = jnp.clip(n_used[:, None] - 1 - srank, 0, 18)
    mant_i = jnp.sum(jnp.where(use, digit.astype(jnp.int64) *
                               _pow10()[mpow], 0), axis=1)
    # exponent part: optional sign after 'e', then digits
    has_e = e_pos < lens
    es_pos = e_pos + 1
    esign_ch = jnp.take_along_axis(
        ch, jnp.clip(es_pos, 0, W - 1)[:, None], axis=1)[:, 0]
    eneg = has_e & (esign_ch == ord("-"))
    eplus = has_e & (esign_ch == ord("+"))
    e_start = es_pos + jnp.logical_or(eneg, eplus).astype(jnp.int32)
    exp_digit = is_digit & (pos >= e_start[:, None])
    n_exp = jnp.sum(exp_digit, axis=1)
    epow = jnp.clip(lens[:, None] - 1 - pos, 0, 18)
    expval = jnp.sum(jnp.where(exp_digit, digit.astype(jnp.int64) *
                               _pow10()[epow], 0), axis=1)
    expval = jnp.where(eneg, -expval, expval)
    dec_exp = expval - frac_digits + (n_sig - n_used)
    mag = jnp.clip(jnp.abs(dec_exp), 0, 308)
    scale = _pow10f()[mag]
    mant_f = mant_i.astype(jnp.float64)
    out = jnp.where(dec_exp >= 0, mant_f * scale, mant_f / scale)
    out = jnp.where(dec_exp > 308,
                    jnp.where(mant_f != 0, jnp.float64(jnp.inf), 0.0), out)
    out = jnp.where(neg, -out, out)
    # every in-row byte must be accounted for by exactly one role
    legal = ((pos < sign_skip[:, None]) | mant_digit |
             (is_dot & (pos == dot_pos[:, None]) &
              (dot_pos[:, None] < mant_end[:, None])) |
             (is_e & (pos == e_pos[:, None])) |
             ((pos == es_pos[:, None]) & (eneg | eplus)[:, None]) |
             exp_digit)
    ok = jnp.asarray(v.validity)
    ok = ok & (lens - sign_skip > 0) & (lens <= W) & (n_mant >= 1)
    ok = ok & jnp.where(has_e, n_exp >= 1, True)
    ok = ok & jnp.all((~in_row) | legal, axis=1)
    return FixedColumn(out.astype(npdt), ok)


def _cast_utf8_to_number(v: VarColumn, npdt) -> FixedColumn:
    """Device decimal parse of utf8 rows (optional '-' sign; non-numeric →
    NULL, matching arrow's safe-cast-to-null behavior on overflow-free
    inputs). Floating targets route to _cast_utf8_to_float, which also
    accepts decimal-point and exponent forms ('3.5', '1e3').
    Fully jittable: a [cap, 20] byte window gather."""
    if np.issubdtype(npdt, np.floating):
        return _cast_utf8_to_float(v, npdt)
    cap = v.capacity
    offs = jnp.asarray(v.offsets).astype(jnp.int32)
    vals = jnp.asarray(v.values)
    lens = offs[1:] - offs[:-1]
    W = 20
    idx = offs[:-1][:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    win = vals[jnp.clip(idx, 0, max(vals.shape[0] - 1, 0))] \
        if vals.shape[0] else jnp.zeros((cap, W), jnp.uint8)
    in_row = jnp.arange(W, dtype=jnp.int32)[None, :] < lens[:, None]
    neg = jnp.logical_and(lens > 0, win[:, 0] == ord("-"))
    sign_skip = neg.astype(jnp.int32)
    digit = (win - ord("0")).astype(jnp.int32)
    is_digit = jnp.logical_and(digit >= 0, digit <= 9)
    pos = jnp.arange(W, dtype=jnp.int32)[None, :]
    eff = jnp.logical_and(in_row, pos >= sign_skip[:, None])
    power = jnp.clip(lens[:, None] - 1 - pos, 0, 18)
    contrib = jnp.where(jnp.logical_and(eff, is_digit),
                        digit.astype(jnp.int64) * _pow10()[power], 0)
    out = jnp.sum(contrib, axis=1)
    out = jnp.where(neg, -out, out)
    ok = jnp.logical_and(
        jnp.asarray(v.validity),
        jnp.logical_and(lens - sign_skip > 0, lens <= W))
    ok = jnp.logical_and(
        ok, jnp.all(jnp.logical_or(jnp.logical_not(eff), is_digit), axis=1))
    if np.issubdtype(npdt, np.floating):
        return FixedColumn(out.astype(npdt), ok)
    return FixedColumn(jnp.where(ok, out, 0).astype(npdt), ok)


def _cast_int_to_utf8(vals: jnp.ndarray, valid) -> VarColumn:
    """Device int64 → decimal utf8 (jittable; gather-only layout: byte k
    finds its row with searchsorted over the exact offsets)."""
    cap = vals.shape[0]
    absv = jnp.abs(vals)
    # digit count via comparison against the power table (log10-free)
    ndig = jnp.sum((absv[:, None] >= _pow10()[None, :]).astype(jnp.int32),
                   axis=1)
    ndig = jnp.maximum(ndig, 1)  # 0 renders as "0"
    lens = ndig + (vals < 0).astype(jnp.int32)
    lens = jnp.where(jnp.asarray(valid), lens, 0)
    offs = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(lens).astype(jnp.int32)])
    vcap = 20 * cap
    k = jnp.arange(vcap, dtype=jnp.int32)
    row = jnp.clip(jnp.searchsorted(offs[1:], k, side="right"), 0, cap - 1)
    pos = k - offs[row]
    is_sign = jnp.logical_and(pos == 0, vals[row] < 0)
    dpos = pos - (vals[row] < 0).astype(jnp.int32)
    p = jnp.clip(ndig[row] - 1 - dpos, 0, 18)
    digit = (absv[row] // _pow10()[p]) % 10
    byte = jnp.where(is_sign, ord("-"), ord("0") + digit).astype(jnp.uint8)
    return VarColumn(byte, offs, jnp.asarray(valid))


# ---------------------------------------------------------------------------
# Expression utilities for the planner
# ---------------------------------------------------------------------------


def expr_columns(expr: Expr) -> set[str]:
    out: set[str] = set()

    def walk(e: Expr):
        if isinstance(e, ColumnRef):
            out.add(e.name)
        for c in e.children():
            walk(c)

    walk(expr)
    return out


def split_conjunction(expr: Expr) -> list[Expr]:
    if isinstance(expr, BinaryOp) and expr.op == "and":
        return split_conjunction(expr.left) + split_conjunction(expr.right)
    return [expr]


def conjoin(exprs: list[Expr]) -> Optional[Expr]:
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryOp("and", out, e)
    return out
