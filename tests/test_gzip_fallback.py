"""The zlib path for gzip/BGZF input, taken where the native library was
built without libdeflate: one linear pass over every member."""

import gzip
import zlib

import numpy as np
import pytest

from exon_tpu import native
from exon_tpu.io import bgzf
from exon_tpu.io.compression import Compression, decompress, gunzip_members

_PAYLOAD = np.random.default_rng(5).integers(
    0, 40, size=300_000, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("stream", [
    bgzf.compress_bgzf(_PAYLOAD),                       # many members + EOF
    gzip.compress(_PAYLOAD),                            # one member
    gzip.compress(_PAYLOAD[:1000]) + b"\0\0\0" + gzip.compress(_PAYLOAD),
    b"",
], ids=["bgzf", "single", "zero-padded", "empty"])
def test_gunzip_members_matches_gzip(stream):
    assert gunzip_members(stream) == gzip.decompress(stream)
    assert gunzip_members(np.frombuffer(stream, np.uint8)) == \
        gzip.decompress(stream)


def test_gunzip_members_rejects_truncated_member():
    stream = bgzf.compress_bgzf(_PAYLOAD)
    with pytest.raises(zlib.error):
        gunzip_members(stream[:len(stream) // 2])


def test_decompress_falls_back_to_zlib(monkeypatch):
    monkeypatch.setattr(native, "gunzip", lambda data: None)
    stream = bgzf.compress_bgzf(_PAYLOAD)
    assert decompress(stream, Compression.BGZF) == _PAYLOAD
    assert bgzf.decompress_all(stream) == _PAYLOAD
    assert bgzf.decompress_all_view(stream).tobytes() == _PAYLOAD
