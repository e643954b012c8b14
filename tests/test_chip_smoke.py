"""chip_smoke.py on the CPU: every phase at a small size against its plain
reference, the plain references against the fixture generators, the
answer comparison, and the refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FASTA = 3000
N_BAM = 5000


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    from benchlib import fixtures as fx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fx, "CACHE", str(tmp_path_factory.mktemp("bench_cache")))
        fasta = fx.make_fasta(N_FASTA)
        bam, _bai = fx.make_bam(N_BAM)
    return fasta, bam, chip_smoke.build_reference(fasta, bam)


@pytest.mark.parametrize("phase", chip_smoke.PHASES, ids=lambda p: p.name)
def test_phase_matches_plain_reference(smoke_data, phase):
    fasta, bam, ref = smoke_data
    want = phase.expected(ref)
    assert want, "the reference must produce rows to compare"
    got = chip_smoke.run_sql(fasta, bam, phase.statements)
    assert chip_smoke.rows_match(got, want), (got[:5], want[:5])


def test_plain_references_read_the_fixtures(smoke_data):
    _fasta, _bam, ref = smoke_data
    assert len(ref.fasta_ids) == len(set(ref.fasta_ids)) == N_FASTA
    assert ((ref.fasta_lengths >= 120) & (ref.fasta_lengths < 680)).all()
    assert set(ref.fasta_first) <= set("ACDEFGHIKLMNPQRSTVWY")
    assert len(ref.bam_starts) == N_BAM
    assert (np.diff(ref.bam_starts) > 0).all()      # coordinate-sorted
    assert (ref.bam_ends - ref.bam_starts == 99).all()  # 100-bp reads
    assert 0 < len(chip_smoke._in_region(ref)) < N_BAM


@pytest.mark.parametrize("got,want,same", [
    ([(1, "A", 2.0)], [(1, "A", 2.0)], True),
    ([(1, "A", 2.0 * (1 + 1e-12))], [(1, "A", 2.0)], True),
    ([(1, "A", 2.0 * (1 + 1e-6))], [(1, "A", 2.0)], False),
    ([(2, "A", 2.0)], [(1, "A", 2.0)], False),
    ([(1, "C", 2.0)], [(1, "A", 2.0)], False),
    ([(1, "A", None)], [(1, "A", 2.0)], False),
    ([(1,)], [(1,), (2,)], False),
])
def test_rows_match_exact_ints_strings_close_floats(got, want, same):
    assert chip_smoke.rows_match(got, want) is same


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("name,setup,query,_expected", chip_smoke.FOUR_CARD,
                         ids=[q[0] for q in chip_smoke.FOUR_CARD])
def test_mesh_plan_matches_single_device(smoke_data, name, setup, query,
                                         _expected, n_shards):
    """The --four queries over a mesh of 1 and 4 of the 8 CPU devices: the
    mesh operators run (a one-device mesh included) and give the
    single-device rows."""
    fasta, bam, _ref = smoke_data
    single = chip_smoke.run_sql(fasta, bam, (*setup, query))
    on_mesh = ("SET exon.distributed = true", f"SET n_shards = {n_shards}",
               *setup)
    got = chip_smoke.run_sql(fasta, bam, (*on_mesh, query))
    assert chip_smoke.rows_match(got, single), (got[:5], single[:5])
    plan = chip_smoke.run_sql(fasta, bam, (*on_mesh, "EXPLAIN ANALYZE " + query))
    assert "Distributed" in str(plan), plan
