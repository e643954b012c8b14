"""ctypes bindings to the native ingest library (native/libexon_native.so).

The C++ scanner replaces the multi-pass numpy decode on the hot ingest path
(the role noodles plays in the reference). Falls back cleanly when the
library isn't built — every caller has a pure-numpy path.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading
import weakref
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False
_ERROR: Optional[str] = None

# ------------------------------------------------------------------
# Huge-page host buffers.
#
# Large fresh allocations fault 4 KiB pages one at a time, which can cost
# more than the decode that fills them. Backing big ingest buffers
# (decompression output, flat record buffers) with MADV_HUGEPAGE anonymous
# mmaps cuts the fault count 512x, and recycling the mappings through a
# small pool makes repeat scans (the steady state of a query engine)
# fault-free.
# ------------------------------------------------------------------

_HUGE_MIN = 1 << 21          # below 2 MiB plain numpy is fine
_POOL_CAP = 3 << 30          # max bytes parked in the free pool
_pool_lock = threading.Lock()
_pool: dict[int, list] = {}  # rounded size -> [mmap, ...]
_pool_bytes = 0


def _round_huge(n: int) -> int:
    # coarse size classes above 64 MiB (round up to 128 MiB) so buffers for
    # different files/formats reuse each other's mappings — a pool miss
    # costs a fresh huge-page fault walk
    if n > (64 << 20):
        return (n + (1 << 27) - 1) & ~((1 << 27) - 1)
    return (n + (1 << 21) - 1) & ~((1 << 21) - 1)


def _pool_put(m: mmap.mmap, size: int) -> None:
    global _pool_bytes
    with _pool_lock:
        if _pool_bytes + size > _POOL_CAP:
            # numpy's buffer export may still be mid-release when this
            # finalizer fires, so close() can raise BufferError; dropping
            # the reference unmaps on dealloc either way
            return
        _pool.setdefault(size, []).append(m)
        _pool_bytes += size


def alloc_buffer(n: int) -> np.ndarray:
    """A writable uint8[n] array backed by a huge-page mapping (pooled).

    The mapping returns to the pool when the array and every view of it
    are garbage-collected; small requests fall back to np.empty."""
    global _pool_bytes
    if n < _HUGE_MIN:
        return np.empty(max(n, 1), np.uint8)
    size = _round_huge(n)
    m = None
    with _pool_lock:
        lst = _pool.get(size)
        if lst:
            m = lst.pop()
            _pool_bytes -= size
    if m is None:
        m = mmap.mmap(-1, size)
        try:
            m.madvise(mmap.MADV_HUGEPAGE)
        except (AttributeError, OSError):
            pass
    arr = np.frombuffer(m, np.uint8, n)
    weakref.finalize(arr, _pool_put, m, size)
    return arr


class _FastaScanResult(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("header_start", ctypes.POINTER(ctypes.c_int64)),
        ("name_start", ctypes.POINTER(ctypes.c_int64)),
        ("name_end", ctypes.POINTER(ctypes.c_int64)),
        ("desc_start", ctypes.POINTER(ctypes.c_int64)),
        ("desc_end", ctypes.POINTER(ctypes.c_int64)),
        ("seq_length", ctypes.POINTER(ctypes.c_int64)),
        ("prefix", ctypes.POINTER(ctypes.c_uint8)),
        ("error", ctypes.c_int64),
    ]


class _FastaIndex(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("header_start", ctypes.POINTER(ctypes.c_int64)),
        ("name_start", ctypes.POINTER(ctypes.c_int64)),
        ("name_end", ctypes.POINTER(ctypes.c_int64)),
        ("desc_start", ctypes.POINTER(ctypes.c_int64)),
        ("desc_end", ctypes.POINTER(ctypes.c_int64)),
        ("seq_length", ctypes.POINTER(ctypes.c_int64)),
    ]


def _so_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native", "libexon_native.so")


def load_error() -> Optional[str]:
    """Why the native library did not load, or None."""
    return _ERROR


def _fail(reason: str) -> bool:
    global _ERROR
    from .tracing import logger

    _ERROR = reason
    logger.warning("native library %s", reason)
    return False


def _build(path: str) -> bool:
    """Compile native/*.cpp into ``path``; log the build's stderr."""
    from .tracing import logger

    build = os.path.join(os.path.dirname(path), "build.sh")
    try:
        proc = subprocess.run(["sh", build], capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return _fail(f"build failed: {e}")
    if proc.returncode != 0:
        return _fail(f"build failed (exit {proc.returncode}): "
                     f"{proc.stderr.strip()[-2000:]}")
    if proc.stderr.strip():
        logger.warning("native library build: %s", proc.stderr.strip())
    return True


def get_lib():
    """Load (building on first use if possible) the native library."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _so_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _fail(f"load failed: {e}")
        return None
    lib.fasta_count_records.restype = ctypes.c_int64
    lib.fasta_count_records.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.fasta_scan.restype = ctypes.c_int64
    lib.fasta_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(_FastaIndex),
                               ctypes.c_char_p, ctypes.c_int64]
    try:
        lib.fasta_scan_mt.restype = ctypes.c_int64
        lib.fasta_scan_mt.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(_FastaIndex),
                                      ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64]
        lib.fasta_count_records_mt.restype = ctypes.c_int64
        lib.fasta_count_records_mt.argtypes = [ctypes.c_char_p,
                                               ctypes.c_int64,
                                               ctypes.c_int64]
    except AttributeError:
        pass
    try:
        lib.fasta_scan_onepass.restype = ctypes.c_int64
        lib.fasta_scan_onepass.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_FastaScanResult)]
        lib.fasta_scan_result_free.restype = None
        lib.fasta_scan_result_free.argtypes = [
            ctypes.POINTER(_FastaScanResult)]
    except AttributeError:
        pass
    try:
        lib.fasta_shard_bounds.restype = ctypes.c_int64
        lib.fasta_shard_bounds.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64)]
        lib.fasta_scan_mt_counted.restype = ctypes.c_int64
        lib.fasta_scan_mt_counted.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_FastaIndex),
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64)]
    except AttributeError:
        pass
    lib.fasta_fill_sequences.restype = ctypes.c_int64
    lib.fasta_fill_sequences.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_char_p]
    lib.encode_dna.restype = ctypes.c_int64
    lib.encode_dna.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.scan_lines.restype = ctypes.c_int64
    lib.scan_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint8,
                               np.ctypeslib.ndpointer(np.int64),
                               np.ctypeslib.ndpointer(np.int64),
                               ctypes.c_int64]
    try:
        lib.exon_gzip_out_size.restype = ctypes.c_int64
        lib.exon_gzip_out_size.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.exon_gunzip.restype = ctypes.c_int64
        lib.exon_gunzip.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int32]
        lib.exon_bgzf_blocks.restype = ctypes.c_int64
        lib.exon_bgzf_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64]
        lib.exon_zstd_decompress.restype = ctypes.c_int64
        lib.exon_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                             ctypes.c_char_p, ctypes.c_int64]
        lib.exon_bam_record_offsets.restype = ctypes.c_int64
        lib.exon_bam_record_offsets.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64]
    except AttributeError:
        pass
    try:
        lib.exon_tsv_scan.restype = ctypes.c_int64
        lib.exon_tsv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint8, ctypes.c_uint8, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            ctypes.c_int64, ctypes.c_int32]
        lib.exon_sdf_count.restype = ctypes.c_int64
        lib.exon_sdf_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int32]
        lib.exon_sdf_terms.restype = ctypes.c_int64
        lib.exon_sdf_terms.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8)]
        lib.exon_parse_ints.restype = ctypes.c_int64
        lib.exon_parse_ints.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint8)]
        lib.exon_strip_spans.restype = ctypes.c_int64
        lib.exon_strip_spans.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64)]
        lib.exon_sdf_keys.restype = ctypes.c_int64
        lib.exon_sdf_keys.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.uint64),
            np.ctypeslib.ndpointer(np.uint8)]
    except AttributeError:
        pass
    try:
        lib.exon_bam_spans.restype = ctypes.c_int64
        lib.exon_bam_spans.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32]
        lib.exon_gather_le.restype = ctypes.c_int64
        lib.exon_gather_le.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32)]
    except AttributeError:
        pass
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def default_threads() -> int:
    """Thread width for native kernels. EXON_TPU_PARTITIONS caps it so a
    '1-worker' configuration is honestly single-threaded end to end (the
    reference's workers-N measures real single-core baselines)."""
    env = os.environ.get("EXON_TPU_PARTITIONS")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


def _as_ptr(data) -> tuple:
    """(c_char_p pointer, length) from bytes or a uint8 array (mmap view)."""
    if isinstance(data, np.ndarray):
        return data.ctypes.data_as(ctypes.c_char_p), data.size
    return data, len(data)


def fasta_scan(data, prefix_k: int = 0):
    """Native single-pass FASTA scan.

    Returns dict with numpy arrays: header/name/desc offsets, seq lengths,
    prefix matrix [n, prefix_k] — or None if the library is unavailable.
    ``data`` may be bytes or a uint8 numpy view (mmap — zero-copy ingest).
    """
    lib = get_lib()
    if lib is None:
        return None
    ptr, n = _as_ptr(data)
    nt = default_threads()
    if hasattr(lib, "fasta_scan_onepass"):
        return _fasta_scan_onepass(lib, ptr, n, prefix_k, nt)
    # fallback: two passes (count + scan)
    bounds = np.zeros(nt + 1, np.int64)
    counts = np.zeros(nt, np.int64)
    use_counted = hasattr(lib, "fasta_shard_bounds")
    if use_counted:
        cap = int(lib.fasta_shard_bounds(ptr, n, nt, bounds, counts))
        if cap < 0:
            from .errors import InvalidSequenceError

            raise InvalidSequenceError("FASTA data before first header")
    elif hasattr(lib, "fasta_count_records_mt"):
        cap = int(lib.fasta_count_records_mt(ptr, n, nt))
    else:
        cap = int(lib.fasta_count_records(ptr, n))
    if cap == 0:
        return {"n": 0}
    data = ptr
    arrs = {k: np.empty(cap, np.int64)
            for k in ("header_start", "name_start", "name_end",
                      "desc_start", "desc_end", "seq_length")}
    idx = _FastaIndex()
    idx.n_records = cap
    for k, a in arrs.items():
        setattr(idx, k, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    k_eff = max(prefix_k, 1)
    prefix = np.zeros((cap, k_eff), np.uint8)
    n_threads = nt
    if use_counted:
        n_rec = lib.fasta_scan_mt_counted(
            data, n, ctypes.byref(idx),
            prefix.ctypes.data_as(ctypes.c_char_p),
            k_eff if prefix_k > 0 else 0, n_threads, bounds, counts)
    elif hasattr(lib, "fasta_scan_mt"):
        n_rec = lib.fasta_scan_mt(data, n, ctypes.byref(idx),
                                  prefix.ctypes.data_as(ctypes.c_char_p),
                                  k_eff if prefix_k > 0 else 0, n_threads)
    else:
        n_rec = lib.fasta_scan(data, n, ctypes.byref(idx),
                               prefix.ctypes.data_as(ctypes.c_char_p),
                               k_eff if prefix_k > 0 else 0)
    if n_rec < 0:
        from .errors import InvalidSequenceError

        raise InvalidSequenceError("FASTA data before first header")
    n_rec = int(n_rec)
    out = {"n": n_rec,
           "prefix": prefix[:n_rec] if prefix_k > 0 else None}
    out.update({k: a[:n_rec] for k, a in arrs.items()})
    return out


def _fasta_scan_onepass(lib, ptr, n: int, prefix_k: int, nt: int):
    """Single data pass: C++ scans into thread-local buffers; we copy the
    stitched outputs into numpy and free the native allocation."""
    res = _FastaScanResult()
    k_eff = max(prefix_k, 0)
    rc = lib.fasta_scan_onepass(ptr, n, k_eff, nt, ctypes.byref(res))
    if rc < 0:
        from .errors import InvalidSequenceError

        raise InvalidSequenceError("FASTA data before first header")
    n_rec = int(res.n_records)
    if n_rec == 0:
        lib.fasta_scan_result_free(ctypes.byref(res))
        return {"n": 0}
    try:
        out = {"n": n_rec}
        for k in ("header_start", "name_start", "name_end",
                  "desc_start", "desc_end", "seq_length"):
            src = np.ctypeslib.as_array(getattr(res, k), shape=(n_rec,))
            out[k] = src.copy()
        if prefix_k > 0:
            pf = np.ctypeslib.as_array(res.prefix, shape=(n_rec, prefix_k))
            out["prefix"] = pf.copy()
        else:
            out["prefix"] = None
    finally:
        lib.fasta_scan_result_free(ctypes.byref(res))
    return out


def fasta_fill_sequences(data: bytes, header_start: np.ndarray,
                         seq_offsets: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    ptr, n = _as_ptr(data)
    total = int(seq_offsets[-1])
    out = np.empty(total, np.uint8)
    wrote = lib.fasta_fill_sequences(ptr, n, header_start,
                                     len(header_start),
                                     seq_offsets.astype(np.int64),
                                     out.ctypes.data_as(ctypes.c_char_p))
    if wrote != total:
        return None
    return out


def gunzip(data, n_threads: int = 0):
    """Decompress gzip/BGZF via libdeflate — BGZF members inflate in
    parallel across all cores (the ingest analog of noodles-bgzf's
    per-block reader, streaming_bgzf.rs:56-118). Returns a uint8 ndarray,
    or None when the native path can't size/handle the stream (caller
    falls back to zlib)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_gunzip"):
        return None
    ptr, n = _as_ptr(data)
    if n < 18:
        return None
    size = int(lib.exon_gzip_out_size(ptr, n))
    if size < 0:
        return None
    for _ in range(3):
        out = alloc_buffer(max(size, 1))
        wrote = int(lib.exon_gunzip(ptr, n, out.ctypes.data_as(
            ctypes.c_char_p), out.size,
            n_threads if n_threads > 0 else default_threads()))
        if wrote >= 0:
            return out[:wrote]
        if wrote == -2:  # size hint short (>4GiB ISIZE wrap / multi-member)
            size = out.size * 4 + (64 << 20)
            continue
        return None
    return None


def bgzf_blocks(data):
    """(in_offset, in_size, out_size) int64 arrays for a wholly-BGZF
    buffer, or None. Lets streaming ingest cut chunk boundaries on block
    edges and decompress each slice natively in parallel."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_bgzf_blocks"):
        return None
    ptr, n = _as_ptr(data)
    cap = max(16, n // 1024)  # BGZF blocks are <=64KiB; start generous
    while True:
        in_off = np.empty(cap, np.int64)
        in_size = np.empty(cap, np.int64)
        out_size = np.empty(cap, np.int64)
        count = int(lib.exon_bgzf_blocks(ptr, n, in_off, in_size, out_size,
                                         cap))
        if count < 0:
            return None
        if count <= cap:
            return in_off[:count], in_size[:count], out_size[:count]
        cap = count


def bam_record_offsets(data, start: int):
    """Record start offsets of BAM alignment blocks (block_size hops in
    C). Returns int64 ndarray, None if unavailable, or raises on a
    malformed record length."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_bam_record_offsets"):
        return None
    ptr, n = _as_ptr(data)
    cap = max(16, (n - start) // 44 + 16)
    while True:
        out = np.empty(cap, np.int64)
        count = int(lib.exon_bam_record_offsets(ptr, n, start, out, cap))
        if count < 0:
            from .errors import ExonError

            raise ExonError(f"malformed BAM record length near offset {start}")
        if count <= cap:
            return out[:count]
        cap = count


def tsv_scan(data, start: int = 0, comment: int = 0, delim: int = 9,
             n_delims: int = 0, line_hint: int = 0,
             keep_empty: bool = False):
    """Threaded line + first-K-delimiter scan of a text buffer.

    Returns (line_start, line_end, dpos[n, n_delims]) with comment-prefixed
    lines skipped (and empty lines too unless keep_empty) and CR stripped,
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_tsv_scan"):
        return None
    ptr, n = _as_ptr(data)
    cap = max(line_hint, min(max((n - start) // 32, 16), 1 << 22))
    while True:
        line_start = np.empty(cap, np.int64)
        line_end = np.empty(cap, np.int64)
        dpos = np.empty(cap * max(n_delims, 1), np.int64) \
            if n_delims > 0 else np.empty(1, np.int64)
        total = int(lib.exon_tsv_scan(ptr, n, start, comment, delim,
                                      n_delims, 1 if keep_empty else 0,
                                      line_start, line_end, dpos,
                                      cap, default_threads()))
        if total <= cap:
            d = dpos[:total * n_delims].reshape(total, n_delims) \
                if n_delims > 0 else None
            return line_start[:total], line_end[:total], d
        cap = total


def sdf_count(data):
    """Number of SDF records ('$$$$'-terminated, plus a non-blank tail),
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_sdf_count"):
        return None
    ptr, n = _as_ptr(data)
    return int(lib.exon_sdf_count(ptr, n, default_threads()))


def sdf_terms(data, starts: np.ndarray, ends: np.ndarray):
    """bool[nl] mask of lines that are exactly '$$$$', or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_sdf_terms"):
        return None
    ptr, n = _as_ptr(data)
    nl = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out = np.empty(nl, np.uint8)
    lib.exon_sdf_terms(ptr, n, starts, ends, nl, out)
    return out.astype(bool)


def strip_spans(data, starts: np.ndarray, ends: np.ndarray):
    """(starts, ends) with ASCII whitespace trimmed both ends, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_strip_spans"):
        return None
    ptr, n = _as_ptr(data)
    count = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out_s = np.empty(count, np.int64)
    out_e = np.empty(count, np.int64)
    rc = int(lib.exon_strip_spans(ptr, n, starts, ends, count, out_s, out_e))
    return (out_s, out_e) if rc >= 0 else None


def sdf_keys(data, starts: np.ndarray, ends: np.ndarray):
    """('> <key>' parse) per line: (key_start, key_end, fnv64, ok) or
    None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_sdf_keys"):
        return None
    ptr, n = _as_ptr(data)
    count = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    ks = np.empty(count, np.int64)
    ke = np.empty(count, np.int64)
    h = np.empty(count, np.uint64)
    ok = np.empty(count, np.uint8)
    lib.exon_sdf_keys(ptr, n, starts, ends, count, ks, ke, h, ok)
    return ks, ke, h, ok.astype(bool)


def parse_ints(data, starts: np.ndarray, ends: np.ndarray):
    """(values int64, ok bool) decimal parse of byte slices, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_parse_ints"):
        return None
    ptr, n = _as_ptr(data)
    count = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    out = np.empty(count, np.int64)
    ok = np.empty(count, np.uint8)
    lib.exon_parse_ints(ptr, n, starts, ends, count, out, ok)
    return out, ok.astype(bool)


def bam_spans(data, offsets: np.ndarray):
    """(ref_id, start_1based, end_1based) int32 arrays per BAM record via
    the single-pass native CIGAR walk, or None if unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_bam_spans"):
        return None
    ptr, n = _as_ptr(data)
    count = len(offsets)
    offsets = np.ascontiguousarray(offsets, np.int64)
    ref_id = np.empty(count, np.int32)
    start = np.empty(count, np.int32)
    end = np.empty(count, np.int32)
    rc = int(lib.exon_bam_spans(ptr, n, offsets, count, ref_id, start, end,
                                default_threads()))
    if rc < 0:
        return None
    return ref_id, start, end


def gather_le(data, idx: np.ndarray, delta: int, width: int):
    """int32[count] = little-endian load of `width` bytes at
    data[idx + delta]; None if the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_gather_le"):
        return None
    ptr, n = _as_ptr(data)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty(len(idx), np.int32)
    rc = int(lib.exon_gather_le(ptr, n, idx, len(idx), delta, width, out))
    return out if rc >= 0 else None


def zstd_decompress(data, size_hint: int = 0):
    """Streaming zstd decompress via libzstd (no frame-content-size
    requirement). Returns uint8 ndarray or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "exon_zstd_decompress"):
        return None
    ptr, n = _as_ptr(data)
    cap = max(size_hint, 4 * n, 1 << 20)
    for _ in range(4):
        out = alloc_buffer(cap)
        wrote = int(lib.exon_zstd_decompress(
            ptr, n, out.ctypes.data_as(ctypes.c_char_p), out.size))
        if wrote >= 0:
            return out[:wrote]
        if wrote == -2:
            cap *= 4
            continue
        return None
    return None


def scan_lines(data, comment: int = 0):
    """Native line scan (skips comment-prefixed lines, strips CR)."""
    lib = get_lib()
    if lib is None:
        return None
    ptr, n = _as_ptr(data)
    if isinstance(data, np.ndarray):
        max_lines = int(np.count_nonzero(data == 10)) + 1
    else:
        max_lines = data.count(b"\n") + 1
    starts = np.empty(max_lines, np.int64)
    ends = np.empty(max_lines, np.int64)
    count = lib.scan_lines(ptr, n, comment, starts, ends, max_lines)
    return starts[:count], ends[:count]
