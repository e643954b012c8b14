"""FASTA decode on the device: raw bytes in, columnar batches out.

Pipeline per chunk (host splits the file at record boundaries into
uniform-capacity chunks):

  phase 1 (jit): byte masks → record count + per-column byte totals
                 (one tiny host sync to pick output capacity buckets)
  phase 2 (jit): stream-compact sequence/name/description bytes into
                 Arrow-layout VarColumns + offsets, all on device

Every pass is a fused mask/cumsum/scatter over the byte stream in device
memory, no host CPU in the loop (the host only does IO + gzip). Semantics
match the host decoder (exon_tpu.formats.fasta) and the reference
(exon-fasta/src/batch_reader.rs): '>' headers, name = to first space,
description nullable, multi-line sequences, DNA/protein integer encodings.
"""

from __future__ import annotations

import functools
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..batch import Batch, FixedColumn, VarColumn, bucket_capacity
from ..ops.device_text import (CR, NL, SPACE, byte_positions, compact,
                               cummax_pos, first_match_in_segment,
                               lengths_to_offsets, line_starts_mask,
                               record_structure, segment_lengths)
from .fasta import DNA_CODE, PROTEIN_CODE, FastaOptions, fasta_schema

DEFAULT_CHUNK = 128 << 20  # 128 MiB raw bytes per device chunk


def split_chunks(data: bytes, max_chunk: int = DEFAULT_CHUNK) -> list[tuple[int, int]]:
    """Split at record boundaries ('\\n>') so every chunk is whole records."""
    n = len(data)
    if n <= max_chunk:
        return [(0, n)]
    spans = []
    start = 0
    while start < n:
        end = min(start + max_chunk, n)
        if end < n:
            cut = data.rfind(b"\n>", start, end)
            if cut <= start:
                cut = data.find(b"\n>", end)
                end = n if cut == -1 else cut + 1
            else:
                end = cut + 1
        spans.append((start, end))
        start = end
    return spans


@functools.partial(jax.jit, static_argnums=(2,))
def _phase1(arr: jnp.ndarray, length, want_hdr: bool):
    """Totals for capacity planning: (n_records, seq_bytes, name_bytes,
    desc_bytes, n_desc)."""
    is_hdr, rec_id, in_hdr = record_structure(arr, length, ord(">"))
    pos = byte_positions(arr.shape[0])
    live = pos < length
    is_nl = arr == NL
    is_cr = arr == CR
    keep_seq = live & ~is_nl & ~is_cr & ~in_hdr & (rec_id >= 0)
    n_rec = jnp.sum(is_hdr, dtype=jnp.int32)
    seq_total = jnp.sum(keep_seq, dtype=jnp.int32)
    if not want_hdr:
        z = jnp.int32(0)
        return n_rec, seq_total, z, z, z
    is_space = arr == SPACE
    first_sp = first_match_in_segment(is_space & in_hdr, is_hdr)
    keep_name = in_hdr & (arr != ord(">")) & (pos < first_sp) & ~is_cr
    keep_desc = in_hdr & (pos > first_sp) & ~is_cr
    return (n_rec, seq_total,
            jnp.sum(keep_name, dtype=jnp.int32),
            jnp.sum(keep_desc, dtype=jnp.int32),
            jnp.int32(0))


@functools.partial(jax.jit,
                   static_argnums=(2, 3, 4, 5, 6, 7))
def _phase2(arr: jnp.ndarray, length, row_cap: int, seq_vcap: int,
            name_vcap: int, desc_vcap: int, want_hdr: bool, encode: str):
    is_hdr, rec_id, in_hdr = record_structure(arr, length, ord(">"))
    pos = byte_positions(arr.shape[0])
    live = pos < length
    is_nl = arr == NL
    is_cr = arr == CR
    n_rec = jnp.sum(is_hdr, dtype=jnp.int32)
    rec_id_c = jnp.clip(rec_id, 0, row_cap - 1)

    out = {}
    keep_seq = live & ~is_nl & ~is_cr & ~in_hdr & (rec_id >= 0)
    seq_vals = arr
    invalid = jnp.int32(0)
    if encode == "integer_encode_dna":
        coded = jnp.asarray(DNA_CODE)[arr]
        invalid = jnp.sum(jnp.logical_and(keep_seq, coded == 0), dtype=jnp.int32)
        seq_vals = coded.astype(jnp.int8)
    elif encode == "integer_encode_protein":
        coded = jnp.asarray(PROTEIN_CODE)[arr]
        invalid = jnp.sum(jnp.logical_and(keep_seq, coded == 0), dtype=jnp.int32)
        seq_vals = coded.astype(jnp.int8)
    seq_flat, _ = compact(seq_vals, keep_seq, seq_vcap)
    seq_off = lengths_to_offsets(segment_lengths(rec_id_c, keep_seq, row_cap))
    out["sequence"] = (seq_flat, seq_off)

    if want_hdr:
        is_space = arr == SPACE
        first_sp = first_match_in_segment(is_space & in_hdr, is_hdr)
        keep_name = in_hdr & (arr != ord(">")) & (pos < first_sp) & ~is_cr
        name_flat, _ = compact(arr, keep_name, name_vcap)
        name_off = lengths_to_offsets(segment_lengths(rec_id_c, keep_name, row_cap))
        out["id"] = (name_flat, name_off)
        keep_desc = in_hdr & (pos > first_sp) & ~is_cr
        desc_flat, _ = compact(arr, keep_desc, desc_vcap)
        desc_off = lengths_to_offsets(segment_lengths(rec_id_c, keep_desc, row_cap))
        # description valid iff the header contained a space
        has_space = segment_lengths(rec_id_c, is_space & in_hdr, row_cap) > 0
        out["description"] = (desc_flat, desc_off, has_space)
    return n_rec, invalid, out


def decode_fasta_device(data: bytes, options: FastaOptions,
                        projection: Optional[list[str]] = None
                        ) -> Iterator[Batch]:
    """Decode raw FASTA bytes into device batches via on-device parsing."""
    schema = fasta_schema(options)
    proj = projection if projection is not None else schema.names
    schema = schema.project(proj)
    want_hdr = ("id" in proj) or ("description" in proj)
    encode = options.sequence_data_type if options.sequence_data_type.startswith(
        "integer") else "utf8"

    if isinstance(data, np.ndarray):
        data = data.tobytes()  # split_chunks / frombuffer want bytes
    for lo, hi in split_chunks(data):
        chunk = np.frombuffer(data, np.uint8, count=hi - lo, offset=lo)
        vcap = bucket_capacity(max(len(chunk), 1), minimum=1024)
        arr = np.full(vcap, NL, np.uint8)
        arr[: len(chunk)] = chunk
        arr_d = jnp.asarray(arr)
        length = jnp.int32(len(chunk))
        n_rec, seq_total, name_total, desc_total, _ = jax.device_get(
            _phase1(arr_d, length, want_hdr))
        n_rec = int(n_rec)
        if n_rec == 0:
            continue
        row_cap = bucket_capacity(n_rec)
        seq_vcap = bucket_capacity(max(int(seq_total), 1), minimum=1024)
        name_vcap = bucket_capacity(max(int(name_total), 1), minimum=1024) if want_hdr else 1
        desc_vcap = bucket_capacity(max(int(desc_total), 1), minimum=1024) if want_hdr else 1
        n_rec_d, invalid, cols = _phase2(arr_d, length, row_cap, seq_vcap,
                                         name_vcap, desc_vcap, want_hdr, encode)
        if encode != "utf8" and int(jax.device_get(invalid)) > 0:
            from ..errors import InvalidSequenceError

            kind = "nucleotide" if encode.endswith("dna") else "amino acid"
            raise InvalidSequenceError(f"invalid {kind} in FASTA sequence")
        validity = jnp.arange(row_cap, dtype=jnp.int32) < n_rec_d
        out_cols = []
        for name in proj:
            if name == "sequence":
                flat, off = cols["sequence"]
                out_cols.append(VarColumn(flat, off, validity))
            elif name == "id":
                flat, off = cols["id"]
                out_cols.append(VarColumn(flat, off, validity))
            elif name == "description":
                flat, off, has_space = cols["description"]
                out_cols.append(VarColumn(flat, off,
                                          jnp.logical_and(validity, has_space)))
        yield Batch(schema, out_cols, n_rec_d)
