"""Drive the engine's main path on an NVIDIA GPU and check every answer.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # six phases on one card
    python chip_smoke.py --four    # distributed parity on four cards

Data are generated from fixed seeds by ``benchlib/fixtures.py`` into
``.bench_cache/`` at the scale of the reference's exon-benchmarks cells:
560,000 protein FASTA records (~250 MB) and a 2.85 M-read BAM (~300 MB)
with its ``.bai``. Each phase runs through ``ExonSession.sql()`` twice,
cold (compiles included) and warm, and both answers are checked against a
plain reference that uses none of the engine's decoders or operators.

Standard output: the card and JAX version, the native-library status, the
data set-up time, one line per phase, and as the last line one JSON object
``{"ok": true, "device": {...}}``. The script exits non-zero, without that
line, when JAX finds no GPU, when a phase raises, or when an answer is
wrong.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gzip
import json
import math
import os
import struct
import subprocess
import sys
import time
from typing import Callable

import numpy as np

REGION = (1_000_000, 40_000_000)   # BAM query region on contig '20'
BIN = 1_000_000                    # position bin of the BAM aggregate
FLOAT_RTOL = 1e-9                  # GPU sums run in another order than numpy


# ---------------------------------------------------------------------------
# Plain reference: Python/numpy passes over the raw files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Reference:
    fasta_ids: list            # record name (header up to the first space)
    fasta_lengths: np.ndarray  # residues per record
    fasta_first: list          # first residue of each record ('' if none)
    bam_starts: np.ndarray     # 1-based start of every mapped read
    bam_ends: np.ndarray       # 1-based inclusive end of every mapped read


def fasta_plain(path: str) -> tuple[list, np.ndarray, list]:
    with open(path, "rb") as f:
        data = f.read()
    ids, lengths, first = [], [], []
    for rec in data.split(b">")[1:]:
        header, _, body = rec.partition(b"\n")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        ids.append(header.split(b" ", 1)[0].rstrip(b"\r").decode())
        lengths.append(len(seq))
        first.append(seq[:1].decode())
    return ids, np.asarray(lengths, np.int64), first


def bgzf_plain(data: bytes) -> bytes:
    """Inflate a BGZF file member by member with the standard library.
    Each member's header gives its size (BSIZE), so no member is copied
    more than once."""
    out, pos = [], 0
    while pos < len(data):
        (bsize,) = struct.unpack_from("<H", data, pos + 16)
        out.append(gzip.decompress(data[pos:pos + bsize + 1]))
        pos += bsize + 1
    return b"".join(out)


def bam_plain(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) of every read of a BAM whose records all have one size
    and one CIGAR op, as ``benchlib.fixtures.make_bam`` writes them."""
    with open(path, "rb") as f:
        raw = bgzf_plain(f.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack_from("<i", raw, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, off)
        off += 8 + l_name
    body = np.frombuffer(raw, np.uint8, offset=off)
    (block,) = struct.unpack_from("<i", raw, off)
    if len(body) % (4 + block):
        raise ValueError(f"{path}: records are not of one size")
    rec = body.reshape(-1, 4 + block)

    def i32(col: int) -> np.ndarray:
        return rec[:, col:col + 4].copy().view("<i4")[:, 0].astype(np.int64)

    if (i32(0) != block).any() or (rec[:, 16:18] != [1, 0]).any():
        raise ValueError(f"{path}: expected fixed-size one-op records")
    cigar_at = 36 + int(rec[0, 12])           # after the read name
    cigar = rec[:, cigar_at:cigar_at + 4].copy().view("<u4")[:, 0]
    if (cigar & 0xF).any():
        raise ValueError(f"{path}: expected a single M op per read")
    mapped = (i32(4) == 0) & (i32(8) >= 0)
    start = i32(8)[mapped] + 1
    return start, start + (cigar[mapped] >> 4).astype(np.int64) - 1


def build_reference(fasta: str, bam: str) -> Reference:
    """Both references; no BAM reads when ``bam`` is empty."""
    ids, lengths, first = fasta_plain(fasta)
    starts, ends = bam_plain(bam) if bam else (np.zeros(0, np.int64),) * 2
    return Reference(ids, lengths, first, starts, ends)


def _groups(ref: Reference) -> dict:
    by_key = collections.defaultdict(list)
    for k, n in zip(ref.fasta_first, ref.fasta_lengths.tolist()):
        by_key[k].append(n)
    return {k: np.asarray(v, np.int64) for k, v in sorted(by_key.items())}


def expect_filter_agg(ref: Reference) -> list:
    keep = ref.fasta_lengths[ref.fasta_lengths > 500]
    return [(len(keep), int(keep.sum()))]


def expect_grouped(ref: Reference) -> list:
    return [(k, len(v), int(v.sum()), int(v.sum()) / len(v))
            for k, v in _groups(ref).items()]


def expect_join(ref: Reference) -> list:
    right = collections.Counter(
        i for i, n in zip(ref.fasta_ids, ref.fasta_lengths) if n > 500)
    pairs = sum(right[i] for i in ref.fasta_ids)
    return [(pairs,)]


def expect_window(ref: Reference) -> list:
    out = []
    for k, v in _groups(ref).items():
        # rank() over ORDER BY length: 1 + rows with a strictly smaller length
        rank = np.searchsorted(np.sort(v), v, side="left") + 1
        out.append((k, len(v), int(rank.sum()), int(rank.max())))
    return out


def _in_region(ref: Reference) -> np.ndarray:
    lo, hi = REGION
    return ref.bam_starts[(ref.bam_starts <= hi) & (ref.bam_ends >= lo)]


def expect_bam(ref: Reference) -> list:
    starts = _in_region(ref)
    bins = starts // BIN
    return [(int(b), int((bins == b).sum()),
             int(starts[bins == b].sum()) / int((bins == b).sum()))
            for b in np.unique(bins)]


# ---------------------------------------------------------------------------
# Phases: the engine's answers through its SQL entry point
# ---------------------------------------------------------------------------

GROUPED_SQL = (
    "SELECT substr(sequence, 1, 1) AS k, count(*) AS n, "
    "sum(length(sequence)) AS total, avg(length(sequence)) AS mean "
    "FROM fasta GROUP BY substr(sequence, 1, 1) ORDER BY k")
JOIN_SQL = (
    "SELECT count(*) AS pairs FROM fasta a JOIN "
    "(SELECT id FROM fasta WHERE length(sequence) > 500) b ON a.id = b.id")
WINDOW_SQL = (
    "SELECT k, count(*) AS n, sum(r) AS rank_sum, max(r) AS rank_max FROM "
    "(SELECT substr(sequence, 1, 1) AS k, rank() OVER (PARTITION BY "
    "substr(sequence, 1, 1) ORDER BY length(sequence)) AS r FROM fasta) t "
    "GROUP BY k ORDER BY k")


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    statements: tuple          # SET statements, then the query
    expected: Callable[[Reference], list]
    scanned: Callable[[Reference], int]


def _n_fasta(ref: Reference) -> int:
    return len(ref.fasta_ids)


PHASES = (
    Phase("fasta-device-decode-filter-agg",
          ("SELECT count(*) AS n, sum(length(sequence)) AS total FROM fasta "
           "WHERE length(sequence) > 500",),
          expect_filter_agg, _n_fasta),
    Phase("grouped-agg-sort", (GROUPED_SQL,), expect_grouped, _n_fasta),
    Phase("equi-join", (JOIN_SQL,), expect_join,
          lambda ref: 2 * len(ref.fasta_ids)),
    Phase("window", (WINDOW_SQL,), expect_window, _n_fasta),
    Phase("bam-region-grouped-agg",
          (f"SELECT start / {BIN} AS bin, count(*) AS n, avg(start) AS mean "
           "FROM bam_indexed_scan('{bam}', "
           f"'20:{REGION[0]}-{REGION[1]}') GROUP BY start / {BIN} "
           "ORDER BY bin",),
          expect_bam, lambda ref: len(_in_region(ref))),
    Phase("distributed-grouped-agg",
          ("SET exon.distributed = true", GROUPED_SQL), expect_grouped,
          _n_fasta),
)

# --four: each query runs on one device and over the four-card mesh
FOUR_CARD = (
    ("grouped-agg", (), GROUPED_SQL, expect_grouped),
    ("partitioned-join", ("SET exon.partitioned_join = true",), JOIN_SQL,
     expect_join),
    ("partition-by-window", (), WINDOW_SQL, expect_window),
)


def run_sql(fasta: str, bam: str, statements) -> list:
    """Run statements in a fresh session over the two tables; rows of the
    last statement's result as tuples."""
    from exon_tpu import ExonSession

    ctx = ExonSession.new_exon()
    ctx.sql(f"CREATE EXTERNAL TABLE fasta STORED AS FASTA LOCATION '{fasta}'")
    *setup, query = statements
    for stmt in setup:
        ctx.sql(stmt)
    table = ctx.sql(query.replace("{bam}", bam)).collect_arrow()
    return list(zip(*table.to_pydict().values()))


def rows_match(got: list, want: list) -> bool:
    """Integers and strings exactly, floats within FLOAT_RTOL."""
    if len(got) != len(want):
        return False
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            return False
        for g, w in zip(g_row, w_row):
            if isinstance(w, float) or isinstance(g, float):
                if g is None or w is None or \
                        not math.isclose(g, w, rel_tol=FLOAT_RTOL, abs_tol=0):
                    return False
            elif g != w:
                return False
    return True


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


class CompileCounter:
    """Counts executables JAX builds (compiled, or read back from the
    persistent cache) through the jax.monitoring compile event."""

    EVENT = "/jax/core/compile/backend_compile_duration"
    HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        import jax

        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event: str, _secs: float, **_kw) -> None:
        if event == self.EVENT:
            self.compiles += 1

    def _event(self, event: str, **_kw) -> None:
        if event == self.HIT:
            self.cache_hits += 1

    def snapshot(self) -> tuple[int, int]:
        return self.compiles, self.cache_hits


def timed(counter: CompileCounter, fn) -> tuple:
    c0, h0 = counter.snapshot()
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    c1, h1 = counter.snapshot()
    return out, secs, c1 - c0, h1 - h0


def card_line() -> str:
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().replace("\n", "; ")
    return (f"card: {smi} | jax {jax.__version__} | device_kind "
            f"{jax.devices()[0].device_kind} x{len(jax.devices())}")


def native_line() -> str:
    from exon_tpu import native

    lib = native.get_lib()
    if lib is None:
        return f"native library: not loaded ({native.load_error()})"
    inflate = ("native" if hasattr(lib, "exon_gunzip")
               else "zlib fallback (built without libdeflate/libzstd)")
    return f"native library: loaded; gzip/BGZF inflate: {inflate}"


def make_data(with_bam: bool) -> tuple[str, str, Reference]:
    """The FASTA and, if asked for, the BAM, at the reference's sizes."""
    from benchlib import fixtures as fx

    t0 = time.perf_counter()
    fasta = fx.make_fasta()
    bam = fx.make_bam()[0] if with_bam else ""
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = build_reference(fasta, bam)
    bam_bytes = os.path.getsize(bam) if bam else 0
    print(f"data: {len(ref.fasta_ids)} FASTA records "
          f"({os.path.getsize(fasta)} B), {len(ref.bam_starts)} BAM reads "
          f"({bam_bytes} B); generated or found in {t_gen:.3f} s, plain "
          f"reference in {time.perf_counter() - t0:.3f} s", flush=True)
    return fasta, bam, ref


def peak_bytes() -> int:
    import jax

    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def run_single(counter: CompileCounter, fasta: str, bam: str,
               ref: Reference) -> bool:
    ok = True
    for i, ph in enumerate(PHASES, 1):
        want = ph.expected(ref)
        got, cold, c_cold, h_cold = timed(
            counter, lambda: run_sql(fasta, bam, ph.statements))
        again, warm, c_warm, _ = timed(
            counter, lambda: run_sql(fasta, bam, ph.statements))
        correct = rows_match(got, want) and rows_match(again, want)
        reached = c_cold > 0
        ok = ok and correct and reached
        peak = peak_bytes()
        print(f"phase {i} {ph.name}: rows_scanned={ph.scanned(ref)} "
              f"rows_out={len(got)} cold_s={cold:.3f} warm_s={warm:.3f} "
              f"compiles_cold={c_cold} (persistent-cache hits {h_cold}) "
              f"compiles_warm={c_warm} peak_bytes_in_use={peak} "
              f"correct={str(correct).lower()}", flush=True)
        if not correct:
            print(f"  engine: {got[:5]}\n  reference: {want[:5]}",
                  file=sys.stderr)
        if not reached:
            print(f"  phase {i} compiled nothing: it did not reach the "
                  "device", file=sys.stderr)
    return ok


def run_four(counter: CompileCounter, fasta: str, bam: str,
             ref: Reference) -> bool:
    ok = True
    for name, setup, query, expected in FOUR_CARD:
        want = expected(ref)
        single, t_one, _, _ = timed(counter, lambda: run_sql(
            fasta, bam, (*setup, query)))
        dist, t_mesh, c_mesh, _ = timed(counter, lambda: run_sql(
            fasta, bam, ("SET exon.distributed = true", *setup, query)))
        parity = rows_match(dist, single)
        correct = rows_match(single, want)
        ok = ok and parity and correct and c_mesh > 0
        print(f"four-card {name}: rows_out={len(dist)} single_s={t_one:.3f} "
              f"mesh_s={t_mesh:.3f} compiles_mesh={c_mesh} "
              f"parity={str(parity).lower()} "
              f"correct={str(correct).lower()}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the distributed queries over 4 cards, "
                         "each compared with the single-device plan")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's first device is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    want_cards = 4 if args.four else 1
    if len(devices) < want_cards:
        print(f"chip_smoke: needs {want_cards} GPUs, JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 1
    try:
        import exon_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the engine is not importable here: {e}",
              file=sys.stderr)
        return 1

    print(card_line(), flush=True)
    print(native_line(), flush=True)
    counter = CompileCounter()
    fasta, bam, ref = make_data(with_bam=not args.four)
    ok = (run_four if args.four else run_single)(counter, fasta, bam, ref)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
