"""Multi-host distributed execution: 2-3 simulated processes x 4 CPU devices.

Spawns two jax.distributed processes (multihost_worker.py) over localhost,
each owning 4 virtual CPU devices, and checks that distributed aggregates
(ungrouped COUNT, GROUP BY, filtered GROUP BY) return exactly the
single-process results while each process decodes only its own file shard
(parallel/mesh.py iter_scan_files).

Role analog: the reference has no multi-node axis (SURVEY §2e); this is the
north-star substrate over jax.distributed + a host-ordered mesh.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_fasta_files(d: str) -> None:
    os.makedirs(d, exist_ok=True)
    # 4 files, 2 per process; descriptions repeat across files so GROUP BY
    # requires a real cross-host exchange
    for f in range(4):
        lines = []
        for i in range(50):
            desc = f"group{i % 5}"
            seq = ("ACGT" if i % 3 else "TTGA") * 4
            lines.append(f">f{f}r{i} {desc}\n{seq}\n")
        with open(os.path.join(d, f"part{f}.fasta"), "w") as fh:
            fh.write("".join(lines))


def _run_workers(tmp_path, data_dir, mode=None, n_procs=2):
    port = _free_port()
    procs = []
    outs = []
    for pid in range(n_procs):
        out = str(tmp_path / f"result_{pid}.json")
        outs.append(out)
        env = dict(os.environ)
        env.update({
            "EXON_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "EXON_TPU_NUM_PROCESSES": str(n_procs),
            "EXON_TPU_PROCESS_ID": str(pid),
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO,
        })
        argv = [sys.executable,
                os.path.join(REPO, "tests", "multihost_worker.py"),
                data_dir, out] + ([mode] if mode else [])
        procs.append(subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    rcs = []
    errs = []
    for p in procs:
        try:
            _out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host workers timed out")
        rcs.append(p.returncode)
        errs.append(err.decode(errors="replace")[-3000:])
    assert rcs == [0] * n_procs, f"worker failures: {errs}"

    results = [json.load(open(o)) for o in outs]
    # every process must see identical (replicated-final) results
    for r in results[1:]:
        assert r == results[0]
    return results[0]


def _make_nine_files(data_dir: str) -> None:
    os.makedirs(data_dir, exist_ok=True)
    for f in range(9):
        lines = []
        for i in range(20):
            desc = f"group{i % 5}"
            seq = ("ACGT" if i % 3 else "TTGA") * 4
            lines.append(f">f{f}r{i} {desc}\n{seq}\n")
        with open(os.path.join(data_dir, f"part{f}.fasta"), "w") as fh:
            fh.write("".join(lines))


def test_two_process_parity(tmp_path):
    data_dir = str(tmp_path / "fasta")
    _make_fasta_files(data_dir)

    got = _run_workers(tmp_path, data_dir)
    # ground truth from the fixture definition: 4 files x 50 records
    assert got["count_star"] == [{"n": 200}]
    # 50 records/file over 5 descriptions -> 10/desc/file, 40 per desc
    assert got["group_by"] == [
        {"description": f"group{i}", "n": 40} for i in range(5)]
    # sequence 'AC%' iff i % 3 != 0: i in 0..49 -> 33 zero-mod, 17*... per
    # desc: i%5==d and i%3!=0 count
    expect = []
    for d in range(5):
        c = sum(1 for i in range(50) if i % 5 == d and i % 3 != 0) * 4
        expect.append({"description": f"group{d}", "n": c})
    assert got["filtered_group_by"] == expect
    # replicated ORDER BY: full file set on every process, global order
    assert got["order_by"] == [{"id": "f0r0"}, {"id": "f0r1"},
                               {"id": "f0r10"}]
    # broadcast join with process-sharded probe: every row matches its own
    # description -> 40 rows per group
    assert got["join"] == [
        {"description": f"group{i}", "n": 40} for i in range(5)]
    # distributed TopK over sharded ingest: group0 rows (i % 5 == 0) sort
    # first; within them ids order lexicographically
    ids = sorted(f"f{f}r{i}" for f in range(4) for i in range(0, 50, 5))
    assert got["topk"] == [
        {"id": i, "description": "group0"} for i in ids[:4]]
    # full ORDER BY (DistributedSortExec): every 'AC%' id, descending
    ac_ids = sorted((f"f{f}r{i}" for f in range(4) for i in range(50)
                     if i % 3 != 0), reverse=True)
    assert got["order_by_full"] == ac_ids
    # PARTITION BY window over the mesh: first 6 rows of group0 by id
    g0 = sorted(f"f{f}r{i}" for f in range(4) for i in range(0, 50, 5))
    assert got["window"] == [
        {"id": i, "rn": r + 1} for r, i in enumerate(g0[:6])]
    # partitioned join: every row matches its description's 40 rows
    assert got["pjoin_count"] == [{"n": 200 * 40}]
    # COPY TO: single writer, consistent count (i%3!=0 rows match 'AC%')
    want_copy = sum(1 for i in range(50) if i % 3 != 0) * 4
    assert got["copy_count"] == want_copy
    out = str(tmp_path / "copy_out.fasta")
    n_records = sum(1 for line in open(out) if line.startswith(">"))
    assert n_records == want_copy


def test_two_process_uneven_files(tmp_path):
    """9 files over 2 processes (5/4 split): the straggler process feeds an
    empty second wave, exercising lockstep template padding."""
    data_dir = str(tmp_path / "fasta9")
    _make_nine_files(data_dir)

    got = _run_workers(tmp_path, data_dir, mode="uneven")
    assert got["count_star"] == [{"n": 180}]
    # non-file-sharding providers (MemTable) must not duplicate rows
    assert got["mem_order"] == [1, 2, 3]
    assert got["mem_group"] == [{"k": k, "n": 1} for k in (1, 2, 3)]
    assert got["group_by"] == [
        {"description": f"group{i}", "n": 36} for i in range(5)]
    ids = sorted(f"f{f}r{i}" for f in range(9) for i in range(0, 20, 5))
    assert got["topk"] == [
        {"id": i, "description": "group0"} for i in ids[:4]]


def test_three_process_parity(tmp_path):
    """3 jax.distributed processes x 4 devices (12-device mesh): the
    lockstep/shard machinery must generalize past the 2-process case."""
    data_dir = str(tmp_path / "fasta9b")
    _make_nine_files(data_dir)

    got = _run_workers(tmp_path, data_dir, mode="uneven", n_procs=3)
    assert got["count_star"] == [{"n": 180}]
    assert got["group_by"] == [
        {"description": f"group{i}", "n": 36} for i in range(5)]
    ids = sorted(f"f{f}r{i}" for f in range(9) for i in range(0, 20, 5))
    assert got["topk"] == [
        {"id": i, "description": "group0"} for i in ids[:4]]
