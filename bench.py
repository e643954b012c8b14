"""Multi-workload benchmark harness mirroring the reference suite
(exon-benchmarks/run_benchmarks.py:38-101, BASELINE.md).

Workloads:
  fasta-scan / fasta-scan-gzip / fasta-scan-zstd  - uniprot-scale
      "sequence ILIKE 'M%'" scan+filter+count (ref 0.789/1.357/0.713 s)
  fasta-parallel-8  - 8-file parallel scan (ref 1.726 s @ 8 workers)
  vcf-region-query  - chr1:10000-10000000 on a >=1 GB bgzf VCF via .tbi
      (ref 0.936 s on its 2.6 GB file; vs_baseline is throughput-scaled)
  bam-scan / bam-region-query  - ~300 MB BAM count / 20:1e6-1e8 via .bai
      (ref 2.381 / 2.444 s)
  sdf-scan  - chembl-style .sdf.gz count (ref 0.445 s, file size unknown
      -> no vs_baseline)

Prints ONE JSON line per workload, then a final headline line (the driver
records the LAST line): the flagship fasta-scan rows/s, with the full
per-workload summary in detail.workloads. vs_baseline semantics: ratio of
OUR throughput to the reference's on its own hardware — (ref_s / our_s) x
(our_bytes / ref_bytes); >1 means faster per byte.
"""

from __future__ import annotations

import json
import os
import sys
import time

BASELINE_ROWS_PER_S = 0.71e6  # reference FASTA scan (headline continuity)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _backend() -> str:
    import jax

    try:
        return str(jax.devices()[0].device_kind)
    except Exception:
        return "unknown"


def _time_best(fn, reps: int = 3, warmup: int = 1):
    for _ in range(warmup):
        result = fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn()
        best = min(best, time.perf_counter() - t0)
    return result, best


def _emit(metric: str, value, unit: str, vs_baseline, detail: dict) -> dict:
    row = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline, "detail": detail}
    print(json.dumps(row), flush=True)
    return row


def run_fasta_workloads(ctx, results: dict) -> None:
    from benchlib import fixtures as fx
    from exon_tpu import col

    plain = fx.make_fasta()
    variants = [("fasta-scan", plain, 0.789)]
    gz = fx.make_fasta_gzip(plain)
    variants.append(("fasta-scan-gzip", gz, 1.357))
    zst = fx.make_fasta_zstd(plain)
    if zst:
        variants.append(("fasta-scan-zstd", zst, 0.713))
    for wid, path, ref_s in variants:
        n_rows = fx.FASTA_RECORDS

        def q():
            return ctx.read_fasta(path).filter(
                col("sequence").ilike("M%")).count()

        matched, best = _time_best(q)
        rows_s = n_rows / best
        vs = (ref_s / best)  # same logical file content as the reference's
        results[wid] = _emit(
            wid + "_rows_per_s", round(rows_s, 1), "rows/s", round(vs, 3),
            {"wall_s": round(best, 4), "rows": n_rows,
             "matched": int(matched),
             "file_mb": round(os.path.getsize(path) / 1e6, 1),
             "gb_s": round(os.path.getsize(path) / 1e9 / best, 3),
             "ref_s": ref_s})


def run_fasta_parallel(ctx, results: dict) -> None:
    from benchlib import fixtures as fx
    from exon_tpu import col

    files = fx.make_fasta_parallel(8)
    d = os.path.join(fx.CACHE, "par8")
    os.makedirs(d, exist_ok=True)
    for f in files:
        dst = os.path.join(d, os.path.basename(f))
        if not os.path.exists(dst):
            os.link(f, dst)
    total_rows = fx.FASTA_RECORDS * 8

    def q():
        return ctx.read_fasta(d).filter(col("sequence").ilike("M%")).count()

    # scaling: 1 worker vs all cores (the reference measures 1..8 workers)
    os.environ["EXON_TPU_PARTITIONS"] = "1"
    _m1, t1 = _time_best(q, reps=1, warmup=1)
    os.environ.pop("EXON_TPU_PARTITIONS", None)
    matched, best = _time_best(q, reps=2)
    ncpu = os.cpu_count() or 1
    eff = (t1 / best) / min(ncpu, 8)
    results["fasta-parallel-8"] = _emit(
        "fasta-parallel-8_rows_per_s", round(total_rows / best, 1), "rows/s",
        round(1.726 / best, 3),
        {"wall_s": round(best, 4), "wall_1worker_s": round(t1, 4),
         "rows": total_rows, "matched": int(matched),
         "workers": ncpu, "host_cores": ncpu,
         "scaling_efficiency": round(eff, 3),
         "ref_s_8workers": 1.726,
         "note": f"own-scaling bounded by {ncpu} host cores on the bench "
                 f"VM; 8-worker parallelism cannot exceed {ncpu}x here"})


def run_vcf_region(ctx, results: dict) -> None:
    from benchlib import fixtures as fx

    path, _tbi = fx.make_vcf_bgzf()
    size = os.path.getsize(path)
    region = "chr1:10000-10000000"

    def q():
        df = ctx.sql("SELECT COUNT(*) FROM vcf_indexed_scan"
                     f"('{path}', '{region}')")
        return df.collect_arrow().column(0)[0].as_py()

    matched, best = _time_best(q)
    ref_s, ref_bytes = 0.936, 2.6e9
    vs = (ref_s / best) * (size / ref_bytes)
    results["vcf-region-query"] = _emit(
        "vcf-region-query_s", round(best, 4), "s", round(vs, 3),
        {"wall_s": round(best, 4), "matched": int(matched),
         "file_mb": round(size / 1e6, 1), "region": region,
         "ref_s": ref_s, "ref_file_gb": 2.6,
         "rows_total": fx.VCF_RECORDS})


def run_bam(ctx, results: dict) -> None:
    from benchlib import fixtures as fx

    path, _bai = fx.make_bam()
    size = os.path.getsize(path)
    ref_bytes = 303e6

    def scan():
        df = ctx.sql(f"SELECT COUNT(*) FROM bam_scan('{path}')")
        return df.collect_arrow().column(0)[0].as_py()

    n, best = _time_best(scan)
    vs = (2.381 / best) * (size / ref_bytes)
    results["bam-scan"] = _emit(
        "bam-scan_s", round(best, 4), "s", round(vs, 3),
        {"wall_s": round(best, 4), "rows": int(n),
         "file_mb": round(size / 1e6, 1),
         "gb_s": round(size / 1e9 / best, 3), "ref_s": 2.381})

    region = "20:1000000-40000000"

    def rq():
        df = ctx.sql("SELECT COUNT(*) FROM bam_indexed_scan"
                     f"('{path}', '{region}')")
        return df.collect_arrow().column(0)[0].as_py()

    n, best = _time_best(rq)
    vs = (2.444 / best) * (size / ref_bytes)
    results["bam-region-query"] = _emit(
        "bam-region-query_s", round(best, 4), "s", round(vs, 3),
        {"wall_s": round(best, 4), "matched": int(n), "region": region,
         "file_mb": round(size / 1e6, 1), "ref_s": 2.444})


def _mzml_stdlib_count(path: str) -> tuple:
    """Competitor baseline on the SAME fixture: stdlib ElementTree
    iterparse spectrum count — the pyteomics/biopython-class comparison
    the reference uses for FASTA (its own mzML hyperfine runs are
    commented out in run_benchmarks.py:101-106, so no exon number
    exists)."""
    import xml.etree.ElementTree as ET

    t0 = time.perf_counter()
    n = 0
    with open(path, "rb") as f:
        for _ev, el in ET.iterparse(f, events=("end",)):
            if el.tag.endswith("}spectrum") or el.tag == "spectrum":
                n += 1
                el.clear()
    return n, time.perf_counter() - t0


def run_mzml(ctx, results: dict) -> None:
    """MzMLScan analog (exon-benchmarks/src/main.rs:31-93): count spectra
    over a ~6k-spectrum mzML. The reference's own mzML hyperfine entries
    are commented out, so the constructed baseline is a stdlib
    ElementTree pass over the same file on the same machine."""
    from benchlib import fixtures as fx

    path = fx.make_mzml()
    size = os.path.getsize(path)

    def q():
        return ctx.read_mzml(path).count()

    n, best = _time_best(q)
    base_n, base_s = _mzml_stdlib_count(path)
    results["mzml-scan"] = _emit(
        "mzml-scan_s", round(best, 4), "s", round(base_s / best, 3),
        {"wall_s": round(best, 4), "rows": int(n),
         "file_mb": round(size / 1e6, 1),
         "rows_per_s": round(n / best, 1),
         "stdlib_etree_s": round(base_s, 4),
         "stdlib_etree_rows": int(base_n),
         "note": "vs_baseline = stdlib ElementTree spectrum count on the "
                 "same fixture/machine (reference's mzML hyperfine runs "
                 "are commented out; no exon number exists)"})


def run_bam_s3(ctx, results: dict) -> None:
    """BAM region query over the REAL S3 client against a loopback
    endpoint (reference exon-bam-s3-query, 9.012 s over WAN; this measures
    the remote-read machinery — SigV4 HTTP, ranged GETs, .bai chunking —
    minus WAN latency, so vs_baseline is null)."""
    from benchlib import fixtures as fx
    from benchlib.s3local import LocalS3Endpoint

    path, _bai = fx.make_bam()
    root = os.path.dirname(path)
    name = os.path.basename(path)
    region = "20:1000000-40000000"
    with LocalS3Endpoint(root) as ep:
        from exon_tpu.io.cloud import S3Store
        from exon_tpu.io.object_store import register_store

        store = S3Store("bench-bucket", endpoint=ep.endpoint,
                        anonymous=True)
        register_store("s3://bench-bucket", store)

        def q():
            df = ctx.sql("SELECT COUNT(*) FROM bam_indexed_scan"
                         f"('s3://bench-bucket/{name}', '{region}')")
            return df.collect_arrow().column(0)[0].as_py()

        n, best = _time_best(q)

    # WAN-shaped comparison: re-run with a simulated 30 ms RTT per S3
    # request (typical same-continent S3 latency) so the number is
    # comparable to the reference's over-WAN 9.012 s
    rtt = 0.030
    with LocalS3Endpoint(root, latency_s=rtt) as ep:
        from exon_tpu.io.cloud import S3Store
        from exon_tpu.io.object_store import register_store

        register_store("s3://bench-bucket",
                       S3Store("bench-bucket", endpoint=ep.endpoint,
                               anonymous=True))
        n2, wan = _time_best(q, reps=2)
    results["bam-s3-region-query"] = _emit(
        "bam-s3-region-query_s", round(best, 4), "s",
        round(9.012 / wan, 3),
        {"wall_s": round(best, 4), "matched": int(n), "region": region,
         "wall_s_sim_wan": round(wan, 4), "sim_rtt_ms": rtt * 1e3,
         "ref_s_wan": 9.012,
         "note": "vs_baseline compares the simulated-WAN run (30 ms RTT "
                 "per request over loopback) against the reference's "
                 "over-WAN number; wall_s is the zero-latency loopback "
                 "run isolating the remote-read machinery"})


def run_sdf(ctx, results: dict) -> None:
    import gzip

    from benchlib import fixtures as fx

    path = fx.make_sdf_gz()
    size = os.path.getsize(path)
    raw_mb = None
    with gzip.open(path, "rb") as f:
        raw = f.read()
    raw_mb = len(raw) / 1e6

    def q():
        return ctx.read_sdf(path).count()

    n, best = _time_best(q)
    # decompress/scan split: a single-member gz count is bound by the
    # one-thread gunzip, not by the record scan
    import numpy as np

    from exon_tpu import native
    from exon_tpu.io.compression import Compression, decompress

    gz_bytes = open(path, "rb").read()
    t_dec = t_scan = float("inf")
    for _ in range(2):  # best of 2: first touch page-faults the buffers
        t0 = time.perf_counter()
        dec = decompress(gz_bytes, Compression.GZIP)
        t_dec = min(t_dec, time.perf_counter() - t0)
        arr = np.frombuffer(dec, np.uint8) \
            if isinstance(dec, (bytes, bytearray)) else dec
        t0 = time.perf_counter()
        native.sdf_count(arr)
        t_scan = min(t_scan, time.perf_counter() - t0)
    results["sdf-scan"] = _emit(
        "sdf-scan_s", round(best, 4), "s", None,
        {"wall_s": round(best, 4), "rows": int(n),
         "file_mb": round(size / 1e6, 1),
         "decompressed_mb": round(raw_mb, 1),
         "s_per_decompressed_gb": round(best / (raw_mb / 1e3), 3),
         "decomp_s": round(t_dec, 4), "term_scan_s": round(t_scan, 4),
         "rows_per_s": round(n / best, 1), "ref_s": 0.445,
         "note": "reference ran chembl_34.sdf.gz of unrecorded size; "
                 "per-GB and split timings make this size-normalizable"})

    # engine-side record scan with decompression out of the picture:
    # count over the uncompressed file (the honest engine-speed number)
    upath = path[:-3]
    if not os.path.exists(upath):
        with open(upath + ".tmp", "wb") as f:
            f.write(raw)
        os.replace(upath + ".tmp", upath)
    del raw

    def qu():
        return ctx.read_sdf(upath).count()

    nu_, bu = _time_best(qu)
    results["sdf-uncompressed-count"] = _emit(
        "sdf-uncompressed-count_s", round(bu, 4), "s", None,
        {"wall_s": round(bu, 4), "rows": int(nu_),
         "rows_per_s": round(nu_ / bu, 1),
         "gb_per_s": round((raw_mb / 1e3) / bu, 2)})

    # full-field materialization on the reference's own shared fixture
    # (exon-core/test-data/datasources/sdf, 6512 rows) — the workload
    # where the property-block parse dominates
    tox_gz = ("/root/reference/exon/exon-core/test-data/datasources/sdf/"
              "tox_benchmark_N6512.sdf.gz")
    if os.path.exists(tox_gz):
        tox = os.path.join(fx.CACHE, "tox_benchmark_N6512.sdf")
        if not os.path.exists(tox):
            with gzip.open(tox_gz, "rb") as f:
                data = f.read()
            with open(tox + ".tmp", "wb") as f:
                f.write(data)
            os.replace(tox + ".tmp", tox)
        tsize = os.path.getsize(tox)

        def qt():
            return ctx.read_sdf(tox).collect_arrow().num_rows

        nt, bt = _time_best(qt)
        results["sdf-tox-fullscan"] = _emit(
            "sdf-tox-fullscan_s", round(bt, 4), "s", None,
            {"wall_s": round(bt, 4), "rows": int(nt),
             "file_mb": round(tsize / 1e6, 1),
             "rows_per_s": round(nt / bt, 1),
             "mb_per_s": round(tsize / 1e6 / bt, 1)})


def run_reverse_complement(ctx, results: dict) -> None:
    """Mirror of the reference's criterion micro-bench
    (exon-core/benches/reverse_complement.rs): 500 random DNA sequences of
    50-1000 bp through the reverse_complement UDF. The reference repo
    ships the bench but not its criterion output, so no vs_baseline."""
    import numpy as np

    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ATCG"),
                               size=int(rng.integers(50, 1001))))
            for _ in range(500)]
    total_bases = sum(len(s) for s in seqs)
    vals = ", ".join(f"('{s}')" for s in seqs)
    ctx.sql(f"CREATE TABLE rc_bench AS VALUES {vals}")

    def q():
        return ctx.sql("SELECT SUM(LENGTH(reverse_complement(column1))) "
                       "FROM rc_bench").to_pandas().iloc[0, 0]

    n, best = _time_best(q)
    results["reverse-complement"] = _emit(
        "reverse-complement_s", round(best, 5), "s", None,
        {"wall_s": round(best, 5), "sequences": 500,
         "bases": int(total_bases),
         "bases_per_s": round(total_bases / best, 1),
         "note": "reference ships this criterion bench without recorded "
                 "output; no comparable number exists. At criterion scale "
                 "(500 seqs, ~270 KB) the wall is dispatch and "
                 "transfer latency, not compute"})


def main() -> None:
    only = set(a for a in sys.argv[1:] if not a.startswith("-"))
    from exon_tpu import ExonSession

    ctx = ExonSession.new_exon()
    results: dict = {}
    steps = [
        ("fasta", run_fasta_workloads),
        ("fasta-parallel", run_fasta_parallel),
        ("vcf", run_vcf_region),
        ("bam", run_bam),
        ("bam-s3", run_bam_s3),
        ("sdf", run_sdf),
        ("mzml", run_mzml),
        ("reverse-complement", run_reverse_complement),
    ]
    for name, fn in steps:
        if only and not any(name.startswith(o) or o.startswith(name)
                            for o in only):
            continue
        try:
            fn(ctx, results)
        except Exception as e:  # a broken workload must not kill the run
            print(json.dumps({"metric": name, "error":
                              f"{type(e).__name__}: {e}"}), file=sys.stderr,
                  flush=True)

    # headline (LAST line — the driver parses this one): flagship FASTA
    head = results.get("fasta-scan")
    rows_s = head["value"] if head else 0.0
    summary = {k: {"value": v["value"], "unit": v["unit"],
                   "vs_baseline": v["vs_baseline"]}
               for k, v in results.items()}
    print(json.dumps({
        "metric": "fasta_scan_filter_count_rows_per_s",
        "value": rows_s,
        "unit": "rows/s",
        "vs_baseline": round(rows_s / BASELINE_ROWS_PER_S, 3) if rows_s
        else 0.0,
        "detail": {"backend": _backend(), "workloads": summary,
                   **({} if not head else head["detail"])},
    }))


if __name__ == "__main__":
    main()
