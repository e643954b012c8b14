"""FASTA decoder: whole-buffer vectorized decode → columnar batches.

Capability parity with exon-fasta (exon-fasta/src/batch_reader.rs:28-111,
array_builder.rs:27-240): schema ``id, description, sequence`` with sequence
representable as Utf8, LargeUtf8, or integer-encoded DNA (A,C,G,T,N → 1..5)
/ protein (25-letter alphabet → 1..25); multi-line sequences; '>' headers
with name = chars to first space, description = rest (null if absent).

Decode strategy (no per-record loop): one pass finds newlines, one pass
classifies header lines, and sequence bytes are compacted with a boolean
mask — all numpy C kernels, leaving the hot filter/aggregate work to the
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from .. import datatypes as dt
from ..batch import Batch, FixedColumn, Schema, VarColumn, batch_from_host
from ..errors import InvalidSequenceError
from .textutil import cumsum_exclusive, gather_slices, to_u8

# Integer encodings — reference: exon-fasta/src/array_builder.rs:144-205
DNA_CODE = np.zeros(256, dtype=np.int8)
for i, c in enumerate(b"ACGTN"):
    DNA_CODE[c] = i + 1
PROTEIN_CODE = np.zeros(256, dtype=np.int8)
for i, c in enumerate(b"ABCDEFGHIKLMNOPQRSTUVWYXZ"):
    PROTEIN_CODE[c] = i + 1


SEQUENCE_DTYPES = {
    "utf8": dt.utf8,
    "large_utf8": dt.large_utf8,
    "integer_encode_dna": dt.list_(dt.int8),
    "integer_encode_protein": dt.list_(dt.int8),
}


@dataclass
class FastaOptions:
    """Mirrors ListingFASTATableOptions (exon-core/src/datasources/fasta)."""

    sequence_data_type: str = "utf8"
    file_extension: str = ".fasta"
    batch_size: int = 8192
    projection: Optional[list[str]] = None
    # planner late-materialization hints: column → prefix bytes needed
    prefix_hints: Optional[dict] = None


def fasta_schema(options: FastaOptions) -> Schema:
    seq_t = SEQUENCE_DTYPES[options.sequence_data_type]
    return Schema.of(
        dt.Field("id", dt.utf8, nullable=False),
        dt.Field("description", dt.utf8, nullable=True),
        dt.Field("sequence", seq_t, nullable=False),
    )


@dataclass
class DecodedFasta:
    """Raw decoded arrays for a whole buffer (pre-batch-split)."""

    n: int
    name_values: np.ndarray
    name_offsets: np.ndarray
    desc_values: np.ndarray
    desc_offsets: np.ndarray
    desc_valid: np.ndarray
    seq_values: np.ndarray  # uint8 or int8 (encoded)
    seq_offsets: np.ndarray


def decode_buffer(data: bytes, options: FastaOptions) -> DecodedFasta:
    arr = to_u8(data)
    if len(arr) == 0:
        z32 = np.zeros(1, np.int32)
        e8 = np.zeros(0, np.uint8)
        return DecodedFasta(0, e8, z32, e8, z32.copy(), np.zeros(0, bool), e8, z32.copy())

    native = _decode_buffer_native(data, arr, options)
    if native is not None:
        return native

    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl) + (1 if (len(nl) == 0 or nl[-1] != len(arr) - 1) else 0)
    line_starts = np.zeros(n_lines, dtype=np.int64)
    line_starts[1:] = nl[: n_lines - 1] + 1
    line_ends = np.empty(n_lines, dtype=np.int64)
    line_ends[: len(nl[:n_lines])] = nl[:n_lines]
    if n_lines > len(nl):
        line_ends[-1] = len(arr)
    # CRLF tolerance
    cr = (line_ends > line_starts) & (arr[np.clip(line_ends - 1, 0, len(arr) - 1)] == 13)
    line_ends = np.where(cr, line_ends - 1, line_ends)

    is_header = arr[line_starts] == ord(">")
    hdr_idx = np.flatnonzero(is_header)
    n = len(hdr_idx)
    if n == 0:
        raise InvalidSequenceError("no FASTA records found (no '>' headers)")
    hstart = line_starts[hdr_idx]
    hend = line_ends[hdr_idx]

    # --- names & descriptions ---------------------------------------------
    sp = np.flatnonzero(arr == 32)
    if len(sp):
        i = np.searchsorted(sp, hstart)
        first_sp = np.where(i < len(sp), sp[np.clip(i, 0, len(sp) - 1)], hend)
        first_sp = np.minimum(first_sp, hend)
    else:
        first_sp = hend
    name_values, name_offsets = gather_slices(arr, hstart + 1, first_sp)
    has_desc = first_sp < hend
    desc_values, desc_offsets = gather_slices(arr, np.minimum(first_sp + 1, hend), hend)

    # --- sequences ---------------------------------------------------------
    keep = np.ones(len(arr), dtype=bool)
    keep[nl] = False
    cr_pos = np.flatnonzero(arr == 13)
    if len(cr_pos):
        keep[cr_pos] = False
    # zero out header lines including '>' (their newline already excluded)
    hdr_lens = hend - hstart
    if hdr_lens.sum() > 0:
        hdr_flat = np.repeat(hstart - cumsum_exclusive(hdr_lens)[:-1], hdr_lens) \
            + np.arange(int(hdr_lens.sum()), dtype=np.int64)
        keep[hdr_flat] = False
    seq_flat = arr[keep]
    # Record starts in kept space, WITHOUT a 254M-element cumsum:
    # kept bytes before hstart_i = hstart_i − (#newlines before) −
    # (#CRs before) − (header-content bytes of earlier headers).
    hdr_cum = np.zeros(n, dtype=np.int64)
    np.cumsum(hdr_lens[:-1], out=hdr_cum[1:])
    rec_starts = (hstart
                  - np.searchsorted(nl, hstart)
                  - (np.searchsorted(cr_pos, hstart) if len(cr_pos) else 0)
                  - hdr_cum)
    seq_offsets = np.empty(n + 1, dtype=np.int64)
    seq_offsets[:-1] = rec_starts
    seq_offsets[-1] = len(seq_flat)
    # text before the first '>' is invalid FASTA
    if rec_starts[0] != 0:
        raise InvalidSequenceError("FASTA data before first header")

    seq_values = seq_flat
    if options.sequence_data_type == "integer_encode_dna":
        seq_values = DNA_CODE[seq_flat]
        if (seq_values == 0).any():
            bad = seq_flat[np.flatnonzero(seq_values == 0)[0]]
            raise InvalidSequenceError(f"invalid nucleotide {chr(bad)!r}")
    elif options.sequence_data_type == "integer_encode_protein":
        seq_values = PROTEIN_CODE[seq_flat]
        if (seq_values == 0).any():
            bad = seq_flat[np.flatnonzero(seq_values == 0)[0]]
            raise InvalidSequenceError(f"invalid amino acid {chr(bad)!r}")

    # offsets stay int64 here (a single buffer may exceed 2 GiB); the
    # per-batch slices rebase into int32 range in _slice_var.
    return DecodedFasta(n, name_values, name_offsets, desc_values,
                        desc_offsets, has_desc, seq_values, seq_offsets)


def _decode_buffer_native(data: bytes, arr: np.ndarray,
                          options: FastaOptions) -> Optional[DecodedFasta]:
    """Single-pass C++ scan + sequence fill (native/fasta_scan.cpp)."""
    from .. import native as nat

    r = nat.fasta_scan(data, prefix_k=0)
    if r is None:
        return None
    n = r["n"]
    if n == 0:
        raise InvalidSequenceError("no FASTA records found (no '>' headers)")
    name_values, name_offsets = gather_slices(arr, r["name_start"], r["name_end"])
    has_desc = r["desc_end"] > r["desc_start"]
    desc_values, desc_offsets = gather_slices(arr, r["desc_start"], r["desc_end"])
    seq_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(r["seq_length"], out=seq_offsets[1:])
    seq_values = nat.fasta_fill_sequences(data, r["header_start"], seq_offsets)
    if seq_values is None:
        return None
    if options.sequence_data_type == "integer_encode_dna":
        coded = DNA_CODE[seq_values]
        if (coded == 0).any():
            bad = seq_values[np.flatnonzero(coded == 0)[0]]
            raise InvalidSequenceError(f"invalid nucleotide {chr(bad)!r}")
        seq_values = coded
    elif options.sequence_data_type == "integer_encode_protein":
        coded = PROTEIN_CODE[seq_values]
        if (coded == 0).any():
            bad = seq_values[np.flatnonzero(coded == 0)[0]]
            raise InvalidSequenceError(f"invalid amino acid {chr(bad)!r}")
        seq_values = coded
    return DecodedFasta(n, name_values, name_offsets, desc_values,
                        desc_offsets, has_desc, seq_values, seq_offsets)


def decoded_to_batches(d: DecodedFasta, options: FastaOptions) -> Iterator[Batch]:
    """Split a decoded buffer into batches of ``batch_size`` rows."""
    schema = fasta_schema(options)
    proj = options.projection or schema.names
    schema = schema.project(proj)
    bs = options.batch_size
    for lo in range(0, max(d.n, 1), bs):
        hi = min(lo + bs, d.n)
        if hi <= lo:
            break
        cols = []
        for name in proj:
            if name == "id":
                cols.append(_slice_var(d.name_values, d.name_offsets, lo, hi))
            elif name == "description":
                c = _slice_var(d.desc_values, d.desc_offsets, lo, hi)
                c.validity = d.desc_valid[lo:hi].copy()
                cols.append(c)
            elif name == "sequence":
                cols.append(_slice_var(d.seq_values, d.seq_offsets, lo, hi))
        yield batch_from_host(schema, cols, hi - lo)


def _slice_var(values: np.ndarray, offsets: np.ndarray, lo: int, hi: int) -> VarColumn:
    off = offsets[lo: hi + 1].astype(np.int64)
    base = off[0]
    return VarColumn(values[base: off[-1]], (off - base).astype(np.int32),
                     np.ones(hi - lo, dtype=bool))


def read_fasta_bytes(data: bytes, options: Optional[FastaOptions] = None) -> Iterator[Batch]:
    options = options or FastaOptions()
    hints = options.prefix_hints or {}
    proj = options.projection or ["id", "description", "sequence"]
    if "sequence" in hints and options.sequence_data_type == "utf8":
        batches = decode_prefix_batches(data, options, hints["sequence"], proj)
        if batches is not None:
            yield from batches
            return
    yield from decoded_to_batches(decode_buffer(data, options), options)


def decode_prefix_batches(data: bytes, options: FastaOptions, k: int,
                          proj: list[str]) -> Optional[Iterator[Batch]]:
    """Late-materialized decode: sequence as PrefixColumn (first-k bytes +
    true lengths) without compacting the full flat buffer. Returns None when
    records wrap prefixes across >2 lines (caller falls back to full decode).
    """
    from ..batch import PrefixColumn

    k = max(int(k), 1)
    arr = to_u8(data)
    if len(arr) == 0:
        return iter(())

    from .. import native as nat

    r = nat.fasta_scan(data, prefix_k=k)
    if r is not None:
        n = r["n"]
        if n == 0:
            raise InvalidSequenceError("no FASTA records found")
        need_hdr = ("id" in proj) or ("description" in proj)
        if need_hdr:
            name_values, name_offsets = gather_slices(arr, r["name_start"],
                                                      r["name_end"])
            desc_values, desc_offsets = gather_slices(arr, r["desc_start"],
                                                      r["desc_end"])
            has_desc = r["desc_end"] > r["desc_start"]
        schema_n = fasta_schema(options).project(proj)
        bs = options.batch_size
        prefix = r["prefix"]
        lengths = r["seq_length"]

        def gen_native():
            for lo in range(0, n, bs):
                hi = min(lo + bs, n)
                cols = []
                for name in proj:
                    if name == "sequence":
                        cols.append(PrefixColumn(prefix[lo:hi],
                                                 lengths[lo:hi].astype(np.int32),
                                                 np.ones(hi - lo, bool)))
                    elif name == "id":
                        cols.append(_slice_var(name_values, name_offsets, lo, hi))
                    elif name == "description":
                        c = _slice_var(desc_values, desc_offsets, lo, hi)
                        c.validity = has_desc[lo:hi].copy()
                        cols.append(c)
                yield batch_from_host(schema_n, cols, hi - lo)

        return gen_native()
    nl = np.flatnonzero(arr == 10)
    n_lines = len(nl) + (1 if (len(nl) == 0 or nl[-1] != len(arr) - 1) else 0)
    line_starts = np.zeros(n_lines, dtype=np.int64)
    line_starts[1:] = nl[: n_lines - 1] + 1
    line_ends = np.empty(n_lines, dtype=np.int64)
    line_ends[: len(nl[:n_lines])] = nl[:n_lines]
    if n_lines > len(nl):
        line_ends[-1] = len(arr)
    cr = (line_ends > line_starts) & (arr[np.clip(line_ends - 1, 0, len(arr) - 1)] == 13)
    line_ends_nc = np.where(cr, line_ends - 1, line_ends)

    is_header = arr[line_starts] == ord(">")
    hdr_idx = np.flatnonzero(is_header)
    n = len(hdr_idx)
    if n == 0:
        raise InvalidSequenceError("no FASTA records found (no '>' headers)")
    hstart = line_starts[hdr_idx]
    hend = line_ends_nc[hdr_idx]

    # true lengths: raw span to next header minus newlines/CRs in the span
    next_hstart = np.empty(n, np.int64)
    next_hstart[:-1] = hstart[1:]
    next_hstart[-1] = len(arr)
    span_start = np.minimum(line_ends[hdr_idx] + 1, len(arr))
    nl_in = np.searchsorted(nl, next_hstart) - np.searchsorted(nl, span_start)
    cr_pos = np.flatnonzero(arr == 13)
    cr_in = (np.searchsorted(cr_pos, next_hstart) -
             np.searchsorted(cr_pos, span_start)) if len(cr_pos) else np.zeros(n, np.int64)
    lengths = (next_hstart - span_start) - nl_in - cr_in
    np.maximum(lengths, 0, out=lengths)

    # prefix from sequence line 1 (+ line 2 when needed)
    l1 = hdr_idx + 1
    has_l1 = (l1 < n_lines) & ~np.isin(l1, hdr_idx)
    s1 = np.where(has_l1, line_starts[np.clip(l1, 0, n_lines - 1)], 0)
    e1 = np.where(has_l1, line_ends_nc[np.clip(l1, 0, n_lines - 1)], 0)
    len1 = e1 - s1
    prefix = np.zeros((n, k), np.uint8)
    idx1 = s1[:, None] + np.arange(k)[None, :]
    m1 = np.arange(k)[None, :] < len1[:, None]
    prefix[m1] = arr[np.clip(idx1, 0, len(arr) - 1)][m1]
    need2 = (len1 < np.minimum(lengths, k))
    if need2.any():
        l2 = hdr_idx + 2
        ok2 = need2 & (l2 < n_lines) & ~np.isin(l2, hdr_idx)
        s2 = np.where(ok2, line_starts[np.clip(l2, 0, n_lines - 1)], 0)
        e2 = np.where(ok2, line_ends_nc[np.clip(l2, 0, n_lines - 1)], 0)
        take2 = np.minimum(e2 - s2, k - len1)
        # still short after two lines → fall back to exact full decode
        if ((len1 + np.maximum(take2, 0)) < np.minimum(lengths, k))[need2].any():
            return None
        pos2 = np.arange(k)[None, :]
        m2 = ok2[:, None] & (pos2 >= len1[:, None]) & \
            (pos2 < (len1 + take2)[:, None])
        src2 = s2[:, None] + (pos2 - len1[:, None])
        prefix[m2] = arr[np.clip(src2, 0, len(arr) - 1)][m2]

    # header name/description only if projected
    d = None
    if ("id" in proj) or ("description" in proj):
        d = decode_buffer(data, options)  # full decode incl. headers

    schema = fasta_schema(options).project(proj)
    bs = options.batch_size

    def gen():
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            cols = []
            for name in proj:
                if name == "sequence":
                    cols.append(PrefixColumn(prefix[lo:hi].copy(),
                                             lengths[lo:hi].astype(np.int32),
                                             np.ones(hi - lo, bool)))
                elif name == "id":
                    cols.append(_slice_var(d.name_values, d.name_offsets, lo, hi))
                elif name == "description":
                    c = _slice_var(d.desc_values, d.desc_offsets, lo, hi)
                    c.validity = d.desc_valid[lo:hi].copy()
                    cols.append(c)
            yield batch_from_host(schema, cols, hi - lo)

    return gen()
