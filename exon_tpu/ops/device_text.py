"""On-device text parsing kernels: raw file bytes → columnar structure.

THE architectural pivot from the reference: Exon parses records one at a
time on the host CPU (noodles parsers, exon-fasta/src/batch_reader.rs). Here
the raw (decompressed) file bytes ship to the device in one bulk copy,
and the *parse itself* runs there as vectorized mask/cumsum/scatter passes
over device memory; the host only does IO + gzip.

All kernels are shape-static: byte buffers padded to bucketed capacities,
true lengths ride as scalars. Core primitives:

  * line structure  — newline masks, line starts, per-byte line ids
  * region masks    — "inside a header line", "before first space", … via
                      position cummax tricks (no sequential loops)
  * stream compact  — keep-mask → dense output via cumsum + scatter
  * segment offsets — per-record lengths → Arrow offsets

Everything lowers to a handful of fused XLA passes over the byte stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NL = 10
CR = 13
SPACE = 32
TAB = 9


def byte_positions(n: int) -> jnp.ndarray:
    return jnp.arange(n, dtype=jnp.int32)


def line_starts_mask(arr: jnp.ndarray, length) -> jnp.ndarray:
    """True at the first byte of every line (within the live region)."""
    n = arr.shape[0]
    prev_nl = jnp.concatenate([jnp.ones(1, bool), arr[:-1] == NL])
    live = byte_positions(n) < length
    return jnp.logical_and(prev_nl, live)


def cummax_pos(flag: jnp.ndarray) -> jnp.ndarray:
    """Position of the most recent True at or before each index (-1 if none).

    One ``lax.cummax`` over the positions of the True entries.
    """
    n = flag.shape[0]
    pos = jnp.where(flag, byte_positions(n), -1)
    return jax.lax.cummax(pos)


def compact(arr: jnp.ndarray, keep: jnp.ndarray, out_cap: int,
            fill=0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stream compaction: gather arr[keep] into a dense prefix.

    Returns (out[out_cap], total kept). One cumsum + one scatter, both
    bound by memory bandwidth.
    """
    n = keep.shape[0]
    kidx = jnp.cumsum(keep.astype(jnp.int32), dtype=jnp.int32) - 1
    total = jnp.where(n > 0, kidx[-1] + 1, 0)
    # every element gets a UNIQUE target: kept → dense prefix, dropped →
    # dump region past out_cap (unique indices let XLA use a
    # collision-free scatter)
    pos = byte_positions(n)
    target = jnp.where(jnp.logical_and(keep, kidx < out_cap),
                       kidx, out_cap + pos)
    out = jnp.full((out_cap + n,), fill, arr.dtype).at[target].set(
        arr, unique_indices=True)
    return out[:out_cap], total


def segment_lengths(seg_ids: jnp.ndarray, mask: jnp.ndarray,
                    num_segments: int) -> jnp.ndarray:
    """Count live bytes per segment id (ids non-decreasing along the byte
    stream — annotated so XLA may use a sorted scatter)."""
    ids = jnp.clip(seg_ids, 0, num_segments - 1)
    return jnp.zeros(num_segments, jnp.int32).at[ids].add(
        mask.astype(jnp.int32), indices_are_sorted=True)


def lengths_to_offsets(lengths: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(lengths, dtype=jnp.int32)])


def record_structure(arr: jnp.ndarray, length, marker: int
                     ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """For marker-line formats ('>' FASTA, '@' FASTQ-header-ish, '#' comments):

    Returns (is_marker_start, rec_id_per_byte, in_marker_line):
      * is_marker_start: line starts whose first byte == marker
      * rec_id_per_byte: 0-based record index per byte (bytes before the
        first marker get -1)
      * in_marker_line: True for bytes inside a marker line (incl. marker,
        excl. the terminating newline)
    """
    ls = line_starts_mask(arr, length)
    is_marker = jnp.logical_and(ls, arr == marker)
    rec_id = jnp.cumsum(is_marker.astype(jnp.int32), dtype=jnp.int32) - 1
    n = arr.shape[0]
    last_marker = cummax_pos(is_marker)
    nl_flag = arr == NL
    last_nl = cummax_pos(nl_flag)
    in_marker = last_marker > last_nl
    live = byte_positions(n) < length
    return is_marker, rec_id, jnp.logical_and(in_marker, live)


def first_match_in_segment(flag: jnp.ndarray, seg_start_flag: jnp.ndarray
                           ) -> jnp.ndarray:
    """Per byte: position of the first True of ``flag`` at/after the most
    recent segment start (or a large sentinel if none yet in this segment).

    Implemented as a forward associative scan over (segment-reset, min-pos).
    """
    n = flag.shape[0]
    pos = byte_positions(n)
    INF = jnp.int32(2**30)
    fcnt = jnp.cumsum(flag.astype(jnp.int32), dtype=jnp.int32)  # inclusive
    ftable, _ = compact(pos, flag, n)
    ftable = jnp.concatenate([ftable, jnp.full(1, INF, jnp.int32)])
    ftable = jnp.where(jnp.arange(n + 1, dtype=jnp.int32) < fcnt[-1],
                       ftable[: n + 1], INF)
    last_seg = cummax_pos(seg_start_flag)
    # flags strictly before the segment start (monotone lookups)
    k = fcnt.at[jnp.clip(last_seg - 1, 0, n - 1)].get(indices_are_sorted=True)
    k = jnp.where(last_seg > 0, k, 0)
    first = ftable.at[jnp.clip(k, 0, n)].get(indices_are_sorted=True)
    return jnp.where(fcnt > k, first, INF)
