"""Scalar UDF kernels — the bio function library.

Device re-implementations of the reference's UDFs
(exon-core/src/udfs/sequence/mod.rs:37-69, udfs/sam/samflags.rs:111-135,
udfs/vcf/mod.rs): every function operates on whole device batches as
vectorized jnp ops (gathers + segment reductions over the flat byte
buffers), so they fuse into the surrounding predicate/projection pipeline.

Functions are registered into plan.expressions' function registry and
annotated with return types for the planner.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import datatypes as dt  # noqa: F401
from .batch import Batch, DictColumn, FixedColumn, VarColumn
from .errors import PlanError
from .ops.layout import byte_row_ids, live_byte_mask, row_lengths
from .plan.expressions import register_function
from .plan.planner import register_function_type


def _require_var(v, fn: str) -> VarColumn:
    if isinstance(v, (str, bytes)):
        # literal argument: broadcast to a 1-row column (constant-folded
        # SELECT f('...') form)
        b = v.encode() if isinstance(v, str) else v
        vals = jnp.asarray(np.frombuffer(b, np.uint8))
        offs = jnp.asarray(np.array([0, len(b)], np.int32))
        return VarColumn(vals, offs, jnp.ones(1, bool))
    if not isinstance(v, VarColumn):
        from .batch import DictColumn as _DC
        from .batch import FixedColumn as _FC, ListColumn as _LC
        from .ops.layout import dict_to_var as _d2v

        if isinstance(v, _DC):
            return _d2v(v)
        if isinstance(v, _LC) and isinstance(v.child, _FC):
            return VarColumn(v.child.values, v.offsets, v.validity)
        raise PlanError(f"{fn} expects a string/sequence column")
    return v


def make_array(batch: Batch, *args) -> VarColumn:
    """DataFusion make_array: scalars → one list per row (constant across
    the batch)."""
    cap = batch.capacity if batch is not None and batch.columns else 1
    vals = np.asarray(list(args))
    n = len(args)
    flat = np.tile(vals, cap)
    offs = (np.arange(cap + 1, dtype=np.int32) * n).astype(np.int32)
    return VarColumn(jnp.asarray(flat), jnp.asarray(offs),
                     jnp.ones(cap, bool))


def _per_row_count(col: VarColumn, byte_mask: jnp.ndarray) -> jnp.ndarray:
    """Count flagged bytes per row (segment-sum over the flat buffer)."""
    vcap = col.value_capacity
    rid = jnp.clip(byte_row_ids(col.offsets, vcap), 0, col.capacity - 1)
    return jnp.zeros(col.capacity, jnp.int32).at[rid].add(byte_mask.astype(jnp.int32))


# -- gc_content (udfs/sequence/gc_content.rs) -------------------------------


def gc_content(batch: Batch, seq) -> jnp.ndarray:
    col = _require_var(seq, "gc_content")
    v = col.values
    is_gc = (v == ord("G")) | (v == ord("C")) | (v == ord("g")) | (v == ord("c"))
    gc = _per_row_count(col, is_gc)
    lens = row_lengths(col.offsets)
    return jnp.where(lens > 0, gc.astype(jnp.float32) / lens.astype(jnp.float32), 0.0)


# -- reverse_complement (udfs/sequence/reverse_complement.rs) ---------------

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in [(b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"),
             (b"a", b"t"), (b"c", b"g"), (b"g", b"c"), (b"t", b"a"),
             (b"N", b"N"), (b"n", b"n"), (b"U", b"A"), (b"u", b"a")]:
    _COMPLEMENT[a[0]] = b[0]


def reverse_complement(batch: Batch, seq) -> VarColumn:
    col = _require_var(seq, "reverse_complement")
    vcap = col.value_capacity
    rid = jnp.clip(byte_row_ids(col.offsets, vcap), 0, col.capacity - 1)
    starts = col.offsets[:-1][rid]
    ends = col.offsets[1:][rid]
    pos = jnp.arange(vcap, dtype=jnp.int32)
    mirror = jnp.clip(starts + (ends - 1 - pos), 0, vcap - 1)
    comp = jnp.asarray(_COMPLEMENT)
    out_vals = comp[col.values[mirror]]
    return VarColumn(out_vals, col.offsets, col.validity)


# -- integer encodings (udfs/sequence/integer_encoding.rs;
#    encodings per exon-fasta/src/array_builder.rs:144-205) ----------------

from .formats.fasta import DNA_CODE  # A,C,G,T,N → 1..5


def integer_encode_dna(batch: Batch, seq) -> VarColumn:
    col = _require_var(seq, "integer_encode_dna")
    table = jnp.asarray(DNA_CODE)
    return VarColumn(table[col.values], col.offsets, col.validity)


# -- quality scores (udfs/sequence/quality_score_*.rs) ----------------------


def quality_score_string_to_list(batch: Batch, q) -> VarColumn:
    """Phred+33 ASCII string → List<Int64> of scores."""
    col = _require_var(q, "quality_score_string_to_list")
    scores = col.values.astype(jnp.int64) - 33
    return VarColumn(scores, col.offsets, col.validity)


def quality_score_list_to_string(batch: Batch, q) -> VarColumn:
    q = _require_var(q, "quality_score_list_to_string")
    vals = (q.values.astype(jnp.int32) + 33).astype(jnp.uint8)
    return VarColumn(vals, q.offsets, q.validity)


# -- trim_polya (udfs/sequence/trim_polya.rs): strip trailing A/a run -------


def trim_polya(batch: Batch, seq) -> VarColumn:
    col = _require_var(seq, "trim_polya")
    vcap = col.value_capacity
    v = col.values
    is_a = (v == ord("A")) | (v == ord("a"))
    rid = jnp.clip(byte_row_ids(col.offsets, vcap), 0, col.capacity - 1)
    pos = jnp.arange(vcap, dtype=jnp.int32)
    # within each row, find the last non-A position (scatter-max)
    last_non_a = jnp.full(col.capacity, -1, jnp.int32).at[rid].max(
        jnp.where(is_a, -1, pos - col.offsets[:-1][rid]))
    lens = row_lengths(col.offsets)
    new_lens = jnp.where(lens > 0, last_non_a + 1, 0)
    # new offsets: keep values in place but shorten rows ⇒ must re-lay out
    new_off = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(new_lens, dtype=jnp.int32)])
    from .ops.layout import relayout_values

    out_vals = relayout_values(col.values, col.offsets[:-1], new_off, vcap)
    return VarColumn(out_vals, new_off, col.validity)


# -- char length ------------------------------------------------------------


def length_fn(batch: Batch, v) -> jnp.ndarray:
    from .batch import PrefixColumn as _PC

    if isinstance(v, _PC):
        # late-materialized strings carry true lengths already
        return jnp.asarray(v.lengths).astype(jnp.int64)
    v = _require_var(v, "length")
    return row_lengths(v.offsets).astype(jnp.int64)


# -- SAM flag predicates (udfs/sam/samflags.rs:111-135) ---------------------

SAM_FLAGS = {
    "is_paired": 0x1,
    "is_properly_aligned": 0x2,
    "is_unmapped": 0x4,
    "is_mate_unmapped": 0x8,
    "is_reverse_complemented": 0x10,
    "is_mate_reverse_complemented": 0x20,
    "is_first_segment": 0x40,
    "is_last_segment": 0x80,
    "is_secondary": 0x100,
    "is_qc_fail": 0x200,
    "is_duplicate": 0x400,
    "is_supplementary": 0x800,
}


def _make_flag_fn(bit: int):
    def fn(batch: Batch, flags) -> jnp.ndarray:
        if isinstance(flags, FixedColumn):
            vals = flags.values
        else:
            vals = jnp.asarray(flags)
        return (vals.astype(jnp.int32) & bit) != 0

    return fn


def is_mapped(batch: Batch, flags) -> jnp.ndarray:
    vals = flags.values if isinstance(flags, FixedColumn) else jnp.asarray(flags)
    return (vals.astype(jnp.int32) & 0x4) == 0


# -- alignment_score (udfs/sequence/alignment_score.rs:95-140;
#    device kernel in ops/alignment.py) -------------------------------------


def alignment_score(batch: Batch, seq, other, band=None) -> jnp.ndarray:
    from .ops.alignment import alignment_scores, alignment_scores_pairwise

    if band is not None and not isinstance(band, (int, np.integer)):
        raise PlanError("alignment_score takes an optional third argument "
                        "of type int32")
    if isinstance(seq, str) and isinstance(other, VarColumn):
        seq, other = other, seq
    if isinstance(seq, VarColumn) and isinstance(other, str):
        return alignment_scores(seq, other.encode())
    if isinstance(seq, str) and isinstance(other, str):
        return alignment_scores_pairwise(_require_var(seq, "alignment_score"),
                                         _require_var(other,
                                                      "alignment_score"))
    if isinstance(seq, VarColumn) and isinstance(other, VarColumn):
        return alignment_scores_pairwise(seq, other)
    raise PlanError("alignment_score expects (sequence_column, 'QUERY')")


# -- locate_regex (udfs/sequence/locate_regex.rs): host-evaluated regex ------


def locate_regex(batch: Batch, seq, pattern) -> "object":
    """Returns List<Struct{start,end,match}> (1-based inclusive-ish per
    reference: start+1, end+1). Regex runs host-side (no device regex)."""
    import re as _re

    import jax as _jax
    from .batch import ListColumn, StructColumn, utf8_column, fixed_column

    if not isinstance(pattern, str):
        raise PlanError("Execution error: locate_regex takes different "
                        "types of arguments, the a sequence and a pattern")
    seq = _require_var(seq, "locate_regex")
    rx = _re.compile(pattern)
    offs = np.asarray(_jax.device_get(seq.offsets))
    vals = np.asarray(_jax.device_get(seq.values))
    valid = np.asarray(_jax.device_get(seq.validity))
    n = len(offs) - 1
    starts, ends, matches, counts = [], [], [], []
    for i in range(n):
        if not valid[i]:
            counts.append(0)
            continue
        s = bytes(vals[offs[i]:offs[i + 1]]).decode("utf-8", "replace")
        ms = list(rx.finditer(s))
        counts.append(len(ms))
        for m in ms:
            starts.append(m.start() + 1)
            ends.append(m.end() + 1)
            matches.append(m.group(0))
    from .formats.textutil import cumsum_exclusive

    loffs = cumsum_exclusive(np.asarray(counts, np.int64))
    entry = StructColumn({
        "start": fixed_column(np.asarray(starts, np.int32)),
        "end": fixed_column(np.asarray(ends, np.int32)),
        "match": utf8_column(matches),
    }, np.ones(len(starts), bool))
    return ListColumn(entry, loffs.astype(np.int32), valid)


LOCATE_REGEX_T = dt.list_(dt.struct([
    dt.Field("start", dt.int32, True),
    dt.Field("end", dt.int32, True),
    dt.Field("match", dt.utf8, True),
]))


# -- mass-spec UDFs (udfs/massspec/{bin_vectors,contains_peak}.rs) ----------


def _as_var(col) -> VarColumn:
    """Normalize a ListColumn-of-fixed (e.g. struct field extraction) to the
    flat VarColumn layout kernels consume."""
    from .batch import FixedColumn, ListColumn

    if isinstance(col, ListColumn) and isinstance(col.child, FixedColumn):
        return VarColumn(col.child.values, col.offsets, col.validity)
    return col


def array_element(batch: Batch, arr, index) -> "object":
    """1-based list element (DataFusion array_element semantics: OOB →
    null)."""
    from .batch import FixedColumn

    arr = _as_var(arr)
    if not isinstance(arr, VarColumn):
        raise PlanError("array_element expects a list column")
    idx = jnp.asarray(index, jnp.int32)
    lens = row_lengths_i32(arr.offsets)
    pos = arr.offsets[:-1] + idx - 1
    ok = jnp.logical_and(idx >= 1, idx <= lens)
    pos = jnp.clip(pos, 0, max(arr.value_capacity - 1, 0))
    return FixedColumn(arr.values[pos], jnp.logical_and(ok, arr.validity))


def array_length(batch: Batch, arr) -> "object":
    from .batch import FixedColumn

    arr = _as_var(arr)
    if not isinstance(arr, VarColumn):
        raise PlanError("array_length expects a list column")
    return FixedColumn(row_lengths_i32(arr.offsets).astype(jnp.int64),
                       arr.validity)


def row_lengths_i32(offsets):
    return (offsets[1:] - offsets[:-1]).astype(jnp.int32)


def _chrom_eq_mask(batch: Batch, chrom, name: str) -> jnp.ndarray:
    from .ops import strings as str_ops

    if isinstance(chrom, DictColumn):
        codes = np.array([v == name for v in chrom.vocab], bool)
        m = jnp.asarray(codes)[jnp.clip(chrom.codes, 0,
                                        max(len(chrom.vocab) - 1, 0))]
        return jnp.logical_and(m, chrom.validity)
    chrom = _require_var(chrom, "chrom_match")
    return jnp.logical_and(
        str_ops.equals_literal(chrom, name.encode()), chrom.validity)


def _interval_mask(batch: Batch, pos, lo, hi) -> jnp.ndarray:
    vals = pos.values if isinstance(pos, FixedColumn) else jnp.asarray(pos)
    m = jnp.ones(vals.shape[0], bool)
    if lo is not None:
        m = jnp.logical_and(m, vals >= lo)
    if hi is not None:
        m = jnp.logical_and(m, vals <= hi)
    if isinstance(pos, FixedColumn):
        m = jnp.logical_and(m, pos.validity)
    return m


def integer_encoding(batch: Batch, seq, alphabet) -> VarColumn:
    """Map each byte to its index in ``alphabet``
    (udfs/sequence/integer_encoding.rs); unknown bytes encode 0."""
    col = _require_var(seq, "integer_encoding")
    alpha = str(alphabet).encode()
    lut = np.zeros(256, np.int64)
    for i, b in enumerate(alpha):
        lut[b] = i
    vals = jnp.asarray(lut)[col.values.astype(jnp.int32)]
    return VarColumn(vals, col.offsets, col.validity)


def chrom_match(batch: Batch, chrom, name) -> jnp.ndarray:
    """Executable chrom predicate (udfs/vcf/mod.rs:156)."""
    return _chrom_eq_mask(batch, chrom, str(name))


def interval_match(batch: Batch, pos, interval) -> jnp.ndarray:
    """pos within '<start>-<end>' (1-based inclusive,
    udfs/vcf/mod.rs:221)."""
    s = str(interval)
    lo_s, _, hi_s = s.partition("-")
    lo = int(lo_s.replace(",", "")) if lo_s else None
    hi = int(hi_s.replace(",", "")) if hi_s else None
    return _interval_mask(batch, pos, lo, hi)


def region_match(batch: Batch, chrom, pos, region) -> jnp.ndarray:
    """chrom:interval overlap predicate (udfs/vcf/mod.rs:54)."""
    from .io.indexes import Region

    r = Region.parse(str(region))
    m = _chrom_eq_mask(batch, chrom, r.name)
    return jnp.logical_and(m, _interval_mask(batch, pos, r.start, r.end))


def contains_peak(batch: Batch, mz, peak_mz, tolerance) -> jnp.ndarray:
    """True if any mz value is within ±tolerance of peak_mz."""
    mz = _as_var(mz)
    if not isinstance(mz, VarColumn):
        raise PlanError("contains_peak expects a List<Float64> column")
    vcap = mz.value_capacity
    rid = jnp.clip(byte_row_ids(mz.offsets, vcap), 0, mz.capacity - 1)
    hit = jnp.abs(mz.values - peak_mz) <= tolerance
    per_row = jnp.zeros(mz.capacity, jnp.int32).at[rid].add(
        hit.astype(jnp.int32), indices_are_sorted=True)
    return jnp.logical_and(per_row > 0, mz.validity)


def bin_vectors(batch: Batch, mz, intensity, min_mz, num_bins, bin_width
                ) -> VarColumn:
    """Sum intensities into fixed-width mz bins → List<Float64>[num_bins]."""
    mz, intensity = _as_var(mz), _as_var(intensity)
    if not (isinstance(mz, VarColumn) and isinstance(intensity, VarColumn)):
        raise PlanError("bin_vectors expects two List<Float64> columns")
    num_bins = int(num_bins)
    cap = mz.capacity
    vcap = mz.value_capacity
    rid = jnp.clip(byte_row_ids(mz.offsets, vcap), 0, cap - 1)
    b = jnp.floor((mz.values - min_mz) / bin_width).astype(jnp.int32)
    ok = jnp.logical_and(b >= 0, b < num_bins)
    flat_bin = rid * num_bins + jnp.clip(b, 0, num_bins - 1)
    sums = jnp.zeros(cap * num_bins, jnp.float64).at[
        jnp.where(ok, flat_bin, cap * num_bins - 1)
    ].add(jnp.where(ok, intensity.values, 0.0))
    offsets = (jnp.arange(cap + 1, dtype=jnp.int32) * num_bins)
    return VarColumn(sums, offsets, mz.validity)


# -- registration -----------------------------------------------------------


def _utf8_type(args):
    return dt.utf8


def _f32_type(args):
    return dt.float32


def _i64_type(args):
    return dt.int64


def _bool_type(args):
    return dt.bool_


def _list_i64_type(args):
    return dt.list_(dt.int64)


def _list_i8_type(args):
    return dt.list_(dt.int8)


def _register_all() -> None:
    register_function("gc_content", gc_content)
    register_function_type("gc_content", _f32_type)
    register_function("reverse_complement", reverse_complement)
    register_function_type("reverse_complement", _utf8_type)
    register_function("integer_encode_dna", integer_encode_dna)
    register_function_type("integer_encode_dna", _list_i8_type)
    register_function("quality_score_string_to_list", quality_score_string_to_list)
    register_function_type("quality_score_string_to_list", _list_i64_type)
    register_function("quality_score_list_to_string", quality_score_list_to_string)
    register_function_type("quality_score_list_to_string", _utf8_type)
    # names as registered in the reference session (udfs/sequence/mod.rs)
    register_function("quality_scores_to_list", quality_score_string_to_list)
    register_function_type("quality_scores_to_list", _list_i64_type)
    register_function("quality_scores_to_string", quality_score_list_to_string)
    register_function_type("quality_scores_to_string", _utf8_type)
    register_function("make_array", make_array)
    register_function_type("make_array", lambda a: dt.list_(dt.int64))
    register_function("trim_polya", trim_polya)
    register_function_type("trim_polya", _utf8_type)
    register_function("length", length_fn)
    register_function_type("length", _i64_type)
    register_function("char_length", length_fn)
    register_function_type("char_length", _i64_type)
    register_function("character_length", length_fn)
    register_function_type("character_length", _i64_type)
    for name, bit in SAM_FLAGS.items():
        register_function(name, _make_flag_fn(bit))
        register_function_type(name, _bool_type)
    register_function("is_mapped", is_mapped)
    register_function_type("is_mapped", _bool_type)

    # host=True: the SW kernel itself is a device jit, but the wrapper syncs
    # the max row length to size the padded matrix
    register_function("alignment_score", alignment_score, host=True)
    register_function_type("alignment_score", lambda a: dt.int32)
    register_function("locate_regex", locate_regex, host=True)
    register_function_type("locate_regex", lambda a: LOCATE_REGEX_T)
    register_function("integer_encoding", integer_encoding)
    register_function_type("integer_encoding", _list_i64_type)
    register_function("chrom_match", chrom_match)
    register_function_type("chrom_match", _bool_type)
    register_function("interval_match", interval_match)
    register_function_type("interval_match", _bool_type)
    register_function("region_match", region_match)
    register_function_type("region_match", _bool_type)
    register_function("array_element", array_element)
    register_function_type("array_element", lambda a: (
        a[0].dtype.value_type if a and a[0].dtype.kind == dt.TypeKind.LIST
        else dt.int64))
    register_function("array_length", array_length)
    register_function_type("array_length", _i64_type)
    register_function("contains_peak", contains_peak)
    register_function_type("contains_peak", _bool_type)
    register_function("bin_vectors", bin_vectors)
    register_function_type("bin_vectors", lambda a: dt.list_(dt.float64))

    # region-filter markers: planned away by providers, never executed
    # (udfs/vcf/vcf_region_filter.rs:42-67)
    from .plan.regions import REGION_FILTER_UDFS

    def _marker(name):
        def fn(batch, *args):
            raise PlanError(
                f"{name} should not be called, check your query "
                "(it must appear as a top-level WHERE conjunct on an "
                "indexed table)")

        return fn

    for name in REGION_FILTER_UDFS:
        register_function(name, _marker(name))
        register_function_type(name, _bool_type)


_register_all()
