"""Start-up settings: where the persistent compile cache goes, that a
mesh is never built from fewer devices than asked for, and that a failed
native build says why."""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINT_CACHE_DIR = ("import exon_tpu, jax; "
                   "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_child(**env_overrides) -> str:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_overrides)
    proc = subprocess.run([sys.executable, "-c", PRINT_CACHE_DIR], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300, check=True)
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_follows_jax_compilation_cache_dir(tmp_path):
    want = str(tmp_path / "xla")
    assert _cache_dir_in_child(JAX_COMPILATION_CACHE_DIR=want) == want


def test_compile_cache_defaults_to_checkout():
    assert _cache_dir_in_child() == os.path.join(REPO, ".jax_cache")


def test_make_mesh_refuses_more_devices_than_visible():
    from exon_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"need {n + 1} devices"):
        make_mesh(n + 1)
    mesh = make_mesh(n)
    assert mesh.shape["shard"] == n
    assert list(mesh.devices.flat) == jax.devices()


def test_native_build_failure_is_reported(tmp_path, monkeypatch, caplog):
    from exon_tpu import native

    (tmp_path / "build.sh").write_text("echo 'g++: not found' >&2; exit 3\n")
    monkeypatch.setattr(native, "_so_path",
                        lambda: str(tmp_path / "libexon_native.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ERROR", None)
    with caplog.at_level("WARNING", logger="exon_tpu"):
        assert native.get_lib() is None
    assert "exit 3" in native.load_error()
    assert "g++: not found" in native.load_error()
    assert any("g++: not found" in r.getMessage() for r in caplog.records)
