"""BGZF (blocked gzip) reading/writing with virtual positions.

Replaces the reference's streaming_bgzf.rs (AsyncBGZFReader::
scan_to_virtual_position, streaming_bgzf.rs:56-118) and noodles-bgzf usage.

A virtual position packs (compressed_block_offset << 16) | within_block
uncompressed offset. Index chunk reads decompress only the needed blocks —
the byte-range pruning that makes region queries index-driven.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def coffset(vpos: int) -> int:
    return vpos >> 16


def uoffset(vpos: int) -> int:
    return vpos & 0xFFFF


def make_vpos(comp: int, unc: int) -> int:
    return (comp << 16) | unc


@dataclass
class BlockInfo:
    comp_offset: int
    comp_size: int
    data: bytes  # decompressed


def read_block(buf, offset: int) -> BlockInfo:
    """Parse + decompress one BGZF block starting at ``offset``."""
    if bytes(memoryview(buf)[offset:offset + 2]) != b"\x1f\x8b":
        raise ValueError(f"not a gzip block at {offset}")
    xlen = struct.unpack_from("<H", buf, offset + 10)[0]
    extra = buf[offset + 12: offset + 12 + xlen]
    bsize = None
    i = 0
    while i + 4 <= len(extra):
        si1, si2 = extra[i], extra[i + 1]
        slen = struct.unpack_from("<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67:  # 'BC'
            bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
            break
        i += 4 + slen
    if bsize is None:
        raise ValueError(f"missing BGZF BC subfield at {offset}")
    cdata_start = offset + 12 + xlen
    cdata_end = offset + bsize - 8
    data = zlib.decompress(buf[cdata_start:cdata_end], -15)
    return BlockInfo(offset, bsize, data)


def block_size_at(buf, offset: int) -> int:
    """Total compressed size of the BGZF block at ``offset`` (BSIZE+1),
    parsed from the header only — no decompression."""
    if bytes(buf[offset:offset + 2]) != b"\x1f\x8b":
        raise ValueError(f"not a gzip block at {offset}")
    xlen = struct.unpack_from("<H", buf, offset + 10)[0]
    i = offset + 12
    end = i + xlen
    while i + 4 <= end:
        si1, si2 = buf[i], buf[i + 1]
        slen = struct.unpack_from("<H", buf, i + 2)[0]
        if si1 == 66 and si2 == 67:
            return struct.unpack_from("<H", buf, i + 4)[0] + 1
        i += 4 + slen
    raise ValueError(f"missing BGZF BC subfield at {offset}")


def decompress_range(buf, vstart: int, vend: int) -> bytes:
    """Decompress the uncompressed byte range [vstart, vend) given the
    containing compressed buffer (virtual positions)."""
    out = decompress_range_view(buf, vstart, vend)
    return out.tobytes() if not isinstance(out, bytes) else out


def decompress_range_view(buf, vstart: int, vend: int):
    """Like decompress_range but returns a zero-copy uint8 ndarray view of
    the (pooled huge-page) decompression buffer when the native path is
    available — the hot indexed-scan path avoids a full output copy."""
    native_out = _decompress_range_native(buf, vstart, vend)
    if native_out is not None:
        return native_out
    out = []
    pos = coffset(vstart)
    first = True
    while pos < len(buf):
        blk = read_block(buf, pos)
        lo = uoffset(vstart) if first else 0
        if pos == coffset(vend):
            out.append(blk.data[lo: uoffset(vend)])
            break
        if pos > coffset(vend):
            break
        out.append(blk.data[lo:])
        pos += blk.comp_size
        first = False
        if blk.comp_size == 0:
            break
    return b"".join(out)


def _decompress_range_native(buf, vstart: int, vend: int):
    """Parallel libdeflate decode of the block slice covering
    [vstart, vend): header-hop to find the slice bounds (no inflate), one
    native multithreaded gunzip, trim by the within-block offsets."""
    from .. import native

    if not native.available():
        return None
    start_off = coffset(vstart)
    end_blk = coffset(vend)
    pos = start_off
    last_size = 0
    try:
        while pos < len(buf):
            size = block_size_at(buf, pos)
            if size == 0:
                break
            if pos >= end_blk:
                if pos > end_blk:
                    return None  # vend not on a block boundary: fallback
                last_size = size
                break
            pos += size
    except ValueError:
        return None
    slice_end = min(pos + last_size, len(buf)) if last_size else min(pos, len(buf))
    import numpy as np

    seg = buf[start_off:slice_end]
    if isinstance(seg, (bytes, bytearray, memoryview)):
        seg = np.frombuffer(seg, np.uint8)
    data = native.gunzip(seg)
    if data is None:
        return None
    lo = uoffset(vstart)
    if last_size and end_blk < len(buf):
        # bytes contributed by the final block beyond vend
        blk = read_block(buf, end_blk)
        hi = len(data) - (len(blk.data) - uoffset(vend))
    else:
        hi = len(data)
    return data[lo:hi]


def decompress_all(buf) -> bytes:
    """Decompress a whole BGZF stream (multi-member gzip fast path)."""
    from .. import native

    out = native.gunzip(buf)
    if out is not None:
        return out.tobytes()
    from .compression import gunzip_members

    return gunzip_members(buf)


def decompress_all_view(buf):
    """Decompress a whole BGZF stream into a zero-copy uint8 ndarray
    (huge-page pooled buffer) — callers that do numpy field gathers over
    the output (BAM/VCF decode) skip the bytes copy entirely."""
    from .. import native

    out = native.gunzip(buf)
    if out is not None:
        return out
    import numpy as np

    from .compression import gunzip_members

    return np.frombuffer(gunzip_members(buf), np.uint8)


def compress_bgzf(data: bytes, block_size: int = 0xFF00, level: int = 6) -> bytes:
    """Compress data into BGZF blocks + EOF marker (writer path)."""
    out = []
    for lo in range(0, len(data), block_size):
        chunk = data[lo:lo + block_size]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 25 + 1
        header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
                  struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2) +
                  struct.pack("<H", bsize - 1))
        trailer = struct.pack("<II", zlib.crc32(chunk), len(chunk))
        out.append(header + cdata + trailer)
    out.append(BGZF_EOF)
    return b"".join(out)
