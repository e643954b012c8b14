"""Native decompression layer: libdeflate gzip/BGZF + libzstd.

Covers the ingest-path primitives added for fast host decode
(native/decomp.cpp): parallel BGZF member inflation, single-shot gzip,
multi-member gzip, streaming zstd, BGZF block tables, BAM record-offset
scanning, and the io-layer wiring (decompress / decompress_view /
decompress_range / streaming chunks).
"""

import gzip
import io
import os

import numpy as np
import pytest

from exon_tpu import native
from exon_tpu.io import bgzf
from exon_tpu.io.compression import (Compression, decompress,
                                     decompress_view)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def _payload(n=3_000_000, seed=7):
    rng = np.random.default_rng(seed)
    return (b"line with some text %d\n" % 12345) * 200 + \
        rng.integers(0, 255, size=n, dtype=np.uint8).tobytes()


def test_gunzip_single_member():
    data = _payload()
    gz = gzip.compress(data, 4)
    out = native.gunzip(gz)
    assert out is not None and out.tobytes() == data


def test_gunzip_bgzf_parallel():
    data = _payload()
    bg = bgzf.compress_bgzf(data)
    out = native.gunzip(np.frombuffer(bg, np.uint8), n_threads=4)
    assert out is not None and out.tobytes() == data


def test_gunzip_multi_member_plain():
    a, b = b"abc" * 50_000, b"xyz" * 80_000
    out = native.gunzip(gzip.compress(a) + gzip.compress(b))
    assert out is not None and out.tobytes() == a + b


def test_gunzip_corrupt_returns_none():
    gz = bytearray(gzip.compress(_payload(100_000)))
    gz[len(gz) // 2] ^= 0xFF
    assert native.gunzip(bytes(gz)) is None


def test_bgzf_blocks_table():
    data = _payload()
    bg = bgzf.compress_bgzf(data)
    in_off, in_size, out_size = native.bgzf_blocks(bg)
    assert int(out_size.sum()) == len(data)
    assert int(in_off[0]) == 0
    assert int((in_off + in_size)[-1]) == len(bg)
    # every recorded offset is a real block start
    for off in in_off[:5]:
        assert bg[int(off):int(off) + 2] == b"\x1f\x8b"


def test_zstd_streaming_unknown_size():
    zstandard = pytest.importorskip("zstandard")
    data = _payload()
    buf = io.BytesIO()
    zstandard.ZstdCompressor(level=3).copy_stream(io.BytesIO(data), buf)
    out = native.zstd_decompress(buf.getvalue())
    assert out is not None and out.tobytes() == data


def test_decompress_wrappers_match_stdlib():
    data = _payload(500_000)
    gz = gzip.compress(data)
    assert decompress(gz, Compression.GZIP) == data
    assert decompress_view(gz, Compression.GZIP).tobytes() == data
    bg = bgzf.compress_bgzf(data)
    assert decompress(bg, Compression.BGZF) == data


def test_decompress_range_native_matches_python():
    data = _payload(400_000)
    bg = bgzf.compress_bgzf(data)
    s0 = bgzf.block_size_at(bg, 0)
    s1 = s0 + bgzf.block_size_at(bg, s0)
    b0 = len(bgzf.read_block(bg, 0).data)
    vs = bgzf.make_vpos(0, 100)
    ve = bgzf.make_vpos(s1, 17)  # ends inside the third block
    got = bgzf.decompress_range(bg, vs, ve)
    b1 = len(bgzf.read_block(bg, s0).data)
    assert got == data[100:b0 + b1 + 17]
    # range ending beyond the buffer: everything from vstart
    got2 = bgzf.decompress_range(bg, vs, bgzf.make_vpos(len(bg) + 10, 0))
    assert got2 == data[100:]


def test_bam_record_offsets_native():
    from exon_tpu.formats import bam as B

    path = ("/root/reference/exon/exon-core/test-data/datasources/bam/"
            "test.bam")
    if not os.path.exists(path):
        pytest.skip("reference BAM fixture absent")
    raw = bgzf.decompress_all(open(path, "rb").read())
    hdr = B.parse_bam_header(raw)
    offs = native.bam_record_offsets(raw, hdr.header_end)
    assert offs is not None
    # parity with the pure-python hop
    py = []
    off = hdr.header_end
    import struct
    while off + 4 <= len(raw):
        (bs,) = struct.unpack_from("<i", raw, off)
        py.append(off)
        off += 4 + bs
    assert offs.tolist() == py


def test_streaming_chunks_native_bgzf_path():
    from exon_tpu.io.streaming import prefetch, stream_record_chunks

    lines = b"".join(b"record-%06d\tpayload\n" % i for i in range(400_000))
    bg = bgzf.compress_bgzf(lines)
    chunks = list(prefetch(stream_record_chunks(
        bg, Compression.BGZF, "line", (), chunk_size=1 << 20)))
    assert b"".join(chunks) == lines
    assert len(chunks) > 1
    for c in chunks:
        assert c.endswith(b"\n")


def test_gather_le_bounds_checked():
    """Out-of-range loads (truncated/corrupt BAM) return None so callers
    fall back to the checked numpy path instead of reading OOB."""
    data = np.arange(16, dtype=np.uint8)
    ok = native.gather_le(data, np.asarray([0, 4, 12]), 0, 4)
    if ok is None:
        pytest.skip("native library unavailable")
    assert ok.tolist() == [50462976, 117835012, 252579084]
    # idx+delta+width past the end
    assert native.gather_le(data, np.asarray([0, 13]), 0, 4) is None
    # negative effective offset
    assert native.gather_le(data, np.asarray([2]), -4, 2) is None


def test_bam_spans_truncated_cigar():
    """A record whose n_cigar walks past the buffer end must fail cleanly
    (None), not read out of bounds."""
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    # minimal fake record: block at offset 0, body starts at 4
    rec = np.zeros(40, np.uint8)
    rec[0:4] = np.frombuffer(np.int32(36).tobytes(), np.uint8)  # block_size
    rec[4 + 8] = 2        # l_read_name
    rec[4 + 12] = 255     # n_cigar low byte -> 255 ops, way past end
    rec[4 + 13] = 0
    out = native.bam_spans(rec, np.asarray([0], np.int64))
    assert out is None
