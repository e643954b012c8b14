"""Vectorized byte-string predicate & transform kernels.

Strings live as flat uint8 + offsets (see batch.VarColumn). Predicates are
computed as bool[cap] masks with pure gathers/compares — no per-row loops —
so XLA lowers them to fused elementwise streams over device memory.

Covers the string surface the reference engine gets from DataFusion
(LIKE/ILIKE, =, starts_with, ends_with, contains, upper/lower) plus the
Exon-specific sequence predicates.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..batch import DictColumn, PrefixColumn, VarColumn
from .layout import byte_row_ids, gather_prefix, row_lengths


def _prefix_of(col, k: int):
    """(prefix[cap,k], valid_mask[cap,k], lengths[cap]) for Var/Prefix cols."""
    if isinstance(col, PrefixColumn):
        if k > col.k:
            raise ValueError(
                f"predicate needs {k}-byte prefix but column staged {col.k}")
        pre = col.prefix[:, :k]
        valid = jnp.arange(k, dtype=jnp.int32)[None, :] < col.lengths[:, None]
        return jnp.where(valid, pre, 0), valid, col.lengths
    pre, valid = gather_prefix(col, k)
    return pre, valid, row_lengths(col.offsets)


def _upper_u8(x: jnp.ndarray) -> jnp.ndarray:
    is_lower = jnp.logical_and(x >= ord("a"), x <= ord("z"))
    return jnp.where(is_lower, x - 32, x)


def _lower_u8(x: jnp.ndarray) -> jnp.ndarray:
    is_upper = jnp.logical_and(x >= ord("A"), x <= ord("Z"))
    return jnp.where(is_upper, x + 32, x)


def upper(col: VarColumn) -> VarColumn:
    return VarColumn(_upper_u8(col.values), col.offsets, col.validity)


def lower(col: VarColumn) -> VarColumn:
    return VarColumn(_lower_u8(col.values), col.offsets, col.validity)


def _prefix_arr(pattern: bytes):
    return jnp.asarray(np.frombuffer(pattern, dtype=np.uint8))


def starts_with(col, prefix: bytes, case_insensitive: bool = False) -> jnp.ndarray:
    k = len(prefix)
    if k == 0:
        return jnp.ones(col.capacity, dtype=bool)
    pre, valid, lens = _prefix_of(col, k)
    pat = _prefix_arr(prefix)
    if case_insensitive:
        pre = _upper_u8(pre)
        pat = _upper_u8(pat)
    long_enough = lens >= k
    eq = jnp.all(jnp.where(valid, pre == pat[None, :], True), axis=1)
    return jnp.logical_and(eq, long_enough)


def ends_with(col: VarColumn, suffix: bytes, case_insensitive: bool = False) -> jnp.ndarray:
    k = len(suffix)
    if k == 0:
        return jnp.ones(col.capacity, dtype=bool)
    ends = col.offsets[1:]
    lens = row_lengths(col.offsets)
    pos = ends[:, None] - k + jnp.arange(k, dtype=jnp.int32)[None, :]
    vals = col.values[jnp.clip(pos, 0, col.value_capacity - 1)]
    pat = _prefix_arr(suffix)
    if case_insensitive:
        vals = _upper_u8(vals)
        pat = _upper_u8(pat)
    eq = jnp.all(vals == pat[None, :], axis=1)
    return jnp.logical_and(eq, lens >= k)


def str_lengths(col) -> jnp.ndarray:
    if isinstance(col, PrefixColumn):
        return col.lengths
    return row_lengths(col.offsets)


def equals_literal(col, lit: bytes, case_insensitive: bool = False) -> jnp.ndarray:
    m = starts_with(col, lit, case_insensitive)
    return jnp.logical_and(m, str_lengths(col) == len(lit))


def contains(col: VarColumn, needle: bytes, case_insensitive: bool = False) -> jnp.ndarray:
    """Substring search: slide the needle over the flat buffer, then reduce
    per-row requiring the window not to cross a row boundary."""
    k = len(needle)
    if k == 0:
        return jnp.ones(col.capacity, dtype=bool)
    vcap = col.value_capacity
    vals = col.values
    pat = _prefix_arr(needle)
    if case_insensitive:
        vals = _upper_u8(vals)
        pat = _upper_u8(pat)
    # hit[j] = values[j:j+k] == needle (windows reading past vcap are False)
    hit = jnp.ones(vcap, dtype=bool)
    for t in range(k):
        idx = jnp.arange(vcap, dtype=jnp.int32) + t
        v = vals[jnp.clip(idx, 0, vcap - 1)]
        hit = jnp.logical_and(hit, jnp.logical_and(v == pat[t], idx < vcap))
    rid = byte_row_ids(col.offsets, vcap)
    cap = col.capacity
    rid = jnp.clip(rid, 0, cap - 1)
    # window must fit within the row: j + k <= offsets[rid+1]
    fits = (jnp.arange(vcap, dtype=jnp.int32) + k) <= col.offsets[rid + 1]
    hit = jnp.logical_and(hit, fits)
    out = jnp.zeros(cap, dtype=jnp.int32).at[rid].add(hit.astype(jnp.int32))
    return out > 0


def tokenize_like(pattern: str, escape: str | None = None) -> list[tuple]:
    """Split a LIKE pattern into '%'-separated chunks of byte tokens.

    Each chunk is a tuple of ints: a UTF-8 byte value, or -1 for the
    single-char wildcard '_'. ``escape`` (the SQL ESCAPE clause character)
    makes the following pattern character literal."""
    chunks: list[list[int]] = [[]]
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if escape is not None and ch == escape:
            i += 1
            if i >= n:
                raise ValueError("LIKE pattern ends with its escape character")
            chunks[-1].extend(pattern[i].encode())
        elif ch == "%":
            chunks.append([])
        elif ch == "_":
            chunks[-1].append(-1)
        else:
            chunks[-1].extend(ch.encode())
        i += 1
    return [tuple(c) for c in chunks]


def like_regex(pattern: str, escape: str | None = None,
               case_insensitive: bool = False):
    """The equivalent compiled ``re`` pattern — host-side LIKE evaluation
    (dictionary vocabularies, tests). '_' matches any char incl. newline."""
    import re

    out = ["^"]
    i, n = 0, len(pattern)
    while i < n:
        ch = pattern[i]
        if escape is not None and ch == escape:
            i += 1
            if i >= n:
                raise ValueError("LIKE pattern ends with its escape character")
            out.append(re.escape(pattern[i]))
        elif ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    out.append("$")
    flags = re.DOTALL | (re.IGNORECASE if case_insensitive else 0)
    return re.compile("".join(out), flags)


def like(col, pattern: str, case_insensitive: bool = False,
         escape: str | None = None) -> jnp.ndarray:
    """SQL LIKE compiled to device kernels — full '%'/'_'/ESCAPE semantics.

    Fast paths ('lit', 'lit%', '%lit', '%lit%', 'a%b' without '_') reuse the
    prefix/suffix/contains kernels (and work on PrefixColumn). The general
    case runs the greedy glob-match: anchor the leading chunk at row start
    and the trailing chunk at row end, then locate each middle chunk at its
    leftmost feasible position via segmented argmin over the flat buffer —
    O(vcap · pattern_len) vectorized compares, no per-row loops.
    """
    chunks = tokenize_like(pattern, escape)
    if not any(t < 0 for c in chunks for t in c):
        bts = [bytes(c) for c in chunks]
        if len(bts) == 1:
            return equals_literal(col, bts[0], case_insensitive)
        if len(bts) == 2:
            pre, suf = bts
            m = jnp.ones(col.capacity, dtype=bool)
            if pre:
                m = jnp.logical_and(m, starts_with(col, pre, case_insensitive))
            if suf:
                m = jnp.logical_and(m, ends_with(col, suf, case_insensitive))
            if pre and suf:
                m = jnp.logical_and(m, str_lengths(col) >= len(pre) + len(suf))
            return m
        if len(bts) == 3 and not bts[0] and not bts[2] and bts[1]:
            return contains(col, bts[1], case_insensitive)
    return _like_general(col, chunks, case_insensitive)


def _match_at(col: VarColumn, chunk, pos: jnp.ndarray,
              case_insensitive: bool) -> jnp.ndarray:
    """bool[cap]: chunk matches at byte position pos[r] of row r (token < 0
    = any byte — chunks are bytes or tokenize_like tuples).

    Caller guarantees pos >= row start; this checks pos + len <= row end.
    """
    k = len(chunk)
    ends = col.offsets[1:]
    ok = pos + k <= ends
    vcap = col.value_capacity
    for t, ch in enumerate(chunk):
        if ch < 0:
            continue
        v = col.values[jnp.clip(pos + t, 0, vcap - 1)]
        pv, pc = (_upper_u8(v), _upper_u8(jnp.uint8(ch))) if case_insensitive \
            else (v, jnp.uint8(ch))
        ok = jnp.logical_and(ok, pv == pc)
    return ok


def _find_from(col: VarColumn, chunk, frm: jnp.ndarray,
               case_insensitive: bool) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Leftmost match of chunk in each row at byte position >= frm[r]
    (token < 0 = any byte).

    Returns (pos int32[cap] — flat position of match, found bool[cap]).
    """
    k = len(chunk)
    vcap = col.value_capacity
    vals = _upper_u8(col.values) if case_insensitive else col.values
    hit = jnp.ones(vcap, dtype=bool)
    for t, ch in enumerate(chunk):
        if ch < 0:
            continue
        c = _upper_u8(jnp.uint8(ch)) if case_insensitive else jnp.uint8(ch)
        idx = jnp.arange(vcap, dtype=jnp.int32) + t
        hit = jnp.logical_and(hit, vals[jnp.clip(idx, 0, vcap - 1)] == c)
    cap = col.capacity
    rid = jnp.clip(byte_row_ids(col.offsets, vcap), 0, cap - 1)
    j = jnp.arange(vcap, dtype=jnp.int32)
    feasible = jnp.logical_and(hit, j >= frm[rid])
    feasible = jnp.logical_and(feasible, j + k <= col.offsets[rid + 1])
    sentinel = jnp.int32(vcap + 1)
    pos = jnp.full(cap, sentinel, jnp.int32).at[rid].min(
        jnp.where(feasible, j, sentinel))
    return pos, pos < sentinel


def _like_general(col, chunks: list[tuple], case_insensitive: bool
                  ) -> jnp.ndarray:
    if isinstance(col, PrefixColumn):
        raise ValueError("general LIKE needs full values, not a PrefixColumn "
                         "(planner must not stage prefix hints for '_'/multi-% "
                         "patterns)")
    starts = col.offsets[:-1]
    ends = col.offsets[1:]
    ok = jnp.ones(col.capacity, dtype=bool)
    if len(chunks) == 1:
        # no '%': anchored full match with '_' wildcards
        c = chunks[0]
        return jnp.logical_and(_match_at(col, c, starts, case_insensitive),
                               row_lengths(col.offsets) == len(c))
    first, *mid, last = chunks
    p = starts
    if first:
        ok = _match_at(col, first, p, case_insensitive)
        p = p + len(first)
    for c in mid:
        if not c:
            continue
        pos, found = _find_from(col, c, p, case_insensitive)
        ok = jnp.logical_and(ok, found)
        p = jnp.where(found, pos + len(c), p)
    if last:
        anchor = ends - len(last)
        ok = jnp.logical_and(ok, anchor >= p)
        ok = jnp.logical_and(ok, _match_at(col, last, jnp.maximum(anchor, 0),
                                           case_insensitive))
    return ok


def dict_equals(col: DictColumn, lit: str) -> jnp.ndarray:
    try:
        code = col.vocab.index(lit)
    except ValueError:
        return jnp.zeros(col.capacity, dtype=bool)
    return col.codes == code


def dict_isin(col: DictColumn, lits: list[str]) -> jnp.ndarray:
    codes = [col.vocab.index(v) for v in lits if v in col.vocab]
    if not codes:
        return jnp.zeros(col.capacity, dtype=bool)
    m = jnp.zeros(col.capacity, dtype=bool)
    for c in codes:
        m = jnp.logical_or(m, col.codes == c)
    return m


def str_length(col: VarColumn) -> jnp.ndarray:
    return row_lengths(col.offsets).astype(jnp.int64)
