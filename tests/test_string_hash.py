"""The device string hash (_hash_var) against its host mirror, which
dictionary vocabularies use, so dict- and var-encoded keys hash alike."""

import jax
import numpy as np
import pytest

from exon_tpu.batch import VarColumn
from exon_tpu.plan.physical import _hash_bytes_host, _hash_var

_RNG = np.random.default_rng(0)
_STRINGS = [b"", b"a", b"ACGT" * 100,
            _RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes()] + [
    _RNG.integers(65, 90, int(n), dtype=np.uint8).tobytes()
    for n in _RNG.integers(0, 50, 200)]


@pytest.mark.parametrize("vcap", [1 << 14, 1 << 17])
def test_hash_var_matches_host_mirror(vcap):
    flat = b"".join(_STRINGS)
    values = np.zeros(vcap, np.uint8)
    values[:len(flat)] = np.frombuffer(flat, np.uint8)
    cap = 256
    offsets = np.full(cap + 1, len(flat), np.int32)
    offsets[1:len(_STRINGS) + 1] = np.cumsum([len(s) for s in _STRINGS])
    offsets[0] = 0
    col = VarColumn(values, offsets, np.arange(cap) < len(_STRINGS))
    got = np.asarray(jax.jit(_hash_var)(col))[:len(_STRINGS)]
    want = np.asarray([_hash_bytes_host(s) for s in _STRINGS], np.int64)
    np.testing.assert_array_equal(got, want)


def test_hash_var_builds_no_power_table():
    """A cumprod over a constant power table is folded by XLA at compile
    time in time quadratic in the value capacity."""
    col = VarColumn(np.zeros(1 << 12, np.uint8),
                    np.arange(65, dtype=np.int32) * 64, np.ones(64, bool))
    assert "cumprod" not in jax.jit(_hash_var).lower(col).as_text()
