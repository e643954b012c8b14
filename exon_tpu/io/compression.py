"""File compression sniffing + decompression (gzip / bgzf / zstd / bz2 / xz).

Mirrors the reference's FileCompressionType inference from extensions
(exon-core/src/datasources/exon_file_type.rs:25-237). BGZF (block-gzip) is a
valid gzip stream, so plain-scan paths decode it with zlib; random access
goes through io.bgzf instead.
"""

from __future__ import annotations

import enum
import gzip
import zlib


class Compression(enum.Enum):
    NONE = "none"
    GZIP = "gzip"
    ZSTD = "zstd"
    BGZF = "bgzf"
    BZIP2 = "bzip2"
    XZ = "xz"


_EXT = {
    ".gz": Compression.GZIP,
    ".gzip": Compression.GZIP,
    ".zst": Compression.ZSTD,
    ".zstd": Compression.ZSTD,
    ".bgz": Compression.BGZF,
    # reference parity: exon_file_type.rs:185-212 infers .bz2/.xz too
    ".bz2": Compression.BZIP2,
    ".bzip2": Compression.BZIP2,
    ".xz": Compression.XZ,
}


def infer_compression(path: str) -> tuple[str, Compression]:
    """Return (path-without-compression-suffix, compression)."""
    lower = path.lower()
    for ext, comp in _EXT.items():
        if lower.endswith(ext):
            return path[: -len(ext)], comp
    return path, Compression.NONE


def is_bgzf(data: bytes) -> bool:
    # BGZF = gzip with FEXTRA subfield "BC" (SAM spec §4.1)
    if len(data) < 18 or data[:2] != b"\x1f\x8b":
        return False
    if not data[3] & 4:
        return False
    xlen = int.from_bytes(data[10:12], "little")
    extra = data[12:12 + xlen]
    i = 0
    while i + 4 <= len(extra):
        si1, si2 = extra[i], extra[i + 1]
        slen = int.from_bytes(extra[i + 2:i + 4], "little")
        if si1 == 66 and si2 == 67:
            return True
        i += 4 + slen
    return False


_MEMBER_CHUNK = 1 << 16  # a BGZF member is at most 64 KiB compressed


def gunzip_members(data) -> bytes:
    """Inflate a multi-member gzip stream (BGZF is thousands of members)
    with zlib in one linear pass. gzip.decompress copies the rest of the
    input once per member, which is quadratic in the member count."""
    view = memoryview(data).cast("B")
    out, pos, n = [], 0, len(view)
    while pos < n:
        d = zlib.decompressobj(31)
        while not d.eof:
            chunk = view[pos:pos + _MEMBER_CHUNK]
            if not len(chunk):
                raise zlib.error("truncated gzip member")
            out.append(d.decompress(chunk))
            pos += len(chunk) - len(d.unused_data)
        while pos < n and view[pos] == 0:  # zero padding between members
            pos += 1
    return b"".join(out)


def decompress(data: bytes, comp: Compression) -> bytes:
    if comp == Compression.NONE:
        # still sniff magic: the reference infers from extension only, but a
        # gzip magic with no suffix is almost certainly a mislabeled file.
        return data
    if comp in (Compression.GZIP, Compression.BGZF):
        from .. import native

        out = native.gunzip(data)  # libdeflate; BGZF blocks in parallel
        if out is not None:
            return out.tobytes()
        return gunzip_members(data)
    if comp == Compression.ZSTD:
        from .. import native

        out = native.zstd_decompress(data)
        if out is not None:
            return out.tobytes()
        import zstandard

        dctx = zstandard.ZstdDecompressor()
        # stream decompress to handle unknown content size
        return dctx.decompressobj().decompress(bytes(data))
    if comp == Compression.BZIP2:
        import bz2

        return bz2.decompress(data)
    if comp == Compression.XZ:
        import lzma

        return lzma.decompress(data)
    raise ValueError(comp)


class _Identity:
    def compress(self, data: bytes) -> bytes:
        return data

    def flush(self) -> bytes:
        return b""


class _BgzfStream:
    """Incremental BGZF: each compress() call emits whole blocks; flush()
    appends the EOF marker."""

    def compress(self, data: bytes) -> bytes:
        from . import bgzf

        out = bgzf.compress_bgzf(data)
        return out[:-len(bgzf.BGZF_EOF)]

    def flush(self) -> bytes:
        from . import bgzf

        return bgzf.BGZF_EOF


def stream_compressor(comp: Compression):
    """Incremental compressor with .compress(bytes)->bytes / .flush()
    (COPY TO writes batch-by-batch instead of buffering the result)."""
    if comp == Compression.NONE:
        return _Identity()
    if comp == Compression.GZIP:
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        return co
    if comp == Compression.BGZF:
        return _BgzfStream()
    if comp == Compression.ZSTD:
        import zstandard

        return zstandard.ZstdCompressor().compressobj()
    if comp == Compression.BZIP2:
        import bz2

        return bz2.BZ2Compressor()
    if comp == Compression.XZ:
        import lzma

        return lzma.LZMACompressor()
    raise ValueError(comp)


def decompress_view(data, comp: Compression):
    """Like :func:`decompress` but returns a uint8 ndarray without the
    final bytes copy — the zero-copy handoff for decoders that accept
    buffer views (FormatSpec.supports_view)."""
    import numpy as np

    if comp == Compression.NONE:
        return data if isinstance(data, np.ndarray) else \
            np.frombuffer(data, np.uint8)
    from .. import native

    if comp in (Compression.GZIP, Compression.BGZF):
        out = native.gunzip(data)
        if out is not None:
            return out
    elif comp == Compression.ZSTD:
        out = native.zstd_decompress(data)
        if out is not None:
            return out
    return np.frombuffer(decompress(bytes(data), comp), np.uint8)


def compress(data: bytes, comp: Compression) -> bytes:
    if comp == Compression.NONE:
        return data
    if comp == Compression.GZIP:
        return gzip.compress(data, compresslevel=6)
    if comp == Compression.ZSTD:
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    if comp == Compression.BGZF:
        from . import bgzf

        return bgzf.compress_bgzf(data)
    if comp == Compression.BZIP2:
        import bz2

        return bz2.compress(data)
    if comp == Compression.XZ:
        import lzma

        return lzma.compress(data)
    raise ValueError(comp)
