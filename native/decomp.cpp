// Native decompression for the ingest path: multithreaded BGZF block
// decode + single-shot gzip via libdeflate, zstd streaming via libzstd.
//
// Role analog in the reference: noodles-bgzf's block inflation and the
// flate2/zstd codecs behind FileCompressionType
// (exon-core/src/datasources/exon_file_type.rs:25-118,
//  exon-core/src/streaming_bgzf.rs:56-118). Here decompression is a
// first-class parallel primitive because host ingest feeds an accelerator,
// not a same-core tokio task: BGZF members are independent deflate streams, so
// all cores inflate concurrently into one preallocated output buffer.
//
// ABI declared locally (no dev headers in the image); linked against the
// system libdeflate.so / libzstd.so.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
struct libdeflate_decompressor;
libdeflate_decompressor *libdeflate_alloc_decompressor(void);
void libdeflate_free_decompressor(libdeflate_decompressor *);
// result enum: 0 = success
int libdeflate_deflate_decompress(libdeflate_decompressor *, const void *in,
                                  size_t in_nbytes, void *out,
                                  size_t out_nbytes_avail, size_t *actual_out);
int libdeflate_gzip_decompress_ex(libdeflate_decompressor *, const void *in,
                                  size_t in_nbytes, void *out,
                                  size_t out_nbytes_avail, size_t *actual_in,
                                  size_t *actual_out);

typedef struct ZSTD_DCtx_s ZSTD_DCtx;
ZSTD_DCtx *ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx *);
typedef struct {
  const void *src;
  size_t size;
  size_t pos;
} ZSTD_inBuffer;
typedef struct {
  void *dst;
  size_t size;
  size_t pos;
} ZSTD_outBuffer;
size_t ZSTD_decompressStream(ZSTD_DCtx *, ZSTD_outBuffer *, ZSTD_inBuffer *);
unsigned ZSTD_isError(size_t);
}

namespace {

inline uint32_t le32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
inline uint16_t le16(const uint8_t *p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

struct Member {
  int64_t in_off;    // member start
  int64_t data_off;  // deflate payload start
  int64_t data_len;  // deflate payload length
  int64_t out_off;
  int64_t out_len;  // ISIZE
};

// Parse one gzip member header at `off`. Returns header length, or -1 if
// malformed. If the member carries the BGZF 'BC' subfield, *bsize_out gets
// the total member length (BSIZE+1), else 0.
int64_t parse_header(const uint8_t *in, int64_t n, int64_t off,
                     int64_t *bsize_out) {
  *bsize_out = 0;
  if (off + 18 > n || in[off] != 0x1f || in[off + 1] != 0x8b ||
      in[off + 2] != 8)
    return -1;
  uint8_t flg = in[off + 3];
  int64_t p = off + 10;
  if (flg & 4) {  // FEXTRA
    if (p + 2 > n) return -1;
    uint16_t xlen = le16(in + p);
    p += 2;
    if (p + xlen > n) return -1;
    int64_t q = p, xend = p + xlen;
    while (q + 4 <= xend) {
      uint8_t si1 = in[q], si2 = in[q + 1];
      uint16_t slen = le16(in + q + 2);
      if (si1 == 66 && si2 == 67 && slen == 2 && q + 6 <= xend)
        *bsize_out = (int64_t)le16(in + q + 4) + 1;
      q += 4 + slen;
    }
    p = xend;
  }
  if (flg & 8) {  // FNAME
    while (p < n && in[p]) p++;
    if (p >= n) return -1;
    p++;
  }
  if (flg & 16) {  // FCOMMENT
    while (p < n && in[p]) p++;
    if (p >= n) return -1;
    p++;
  }
  if (flg & 2) p += 2;  // FHCRC
  return p - off;
}

// Walk BGZF members building the block table. Returns true if the WHOLE
// buffer is BGZF-framed members.
bool scan_bgzf(const uint8_t *in, int64_t n, std::vector<Member> &members) {
  int64_t off = 0, out = 0;
  while (off < n) {
    int64_t bsize;
    int64_t hlen = parse_header(in, n, off, &bsize);
    if (hlen < 0 || bsize == 0 || off + bsize > n || bsize < hlen + 8)
      return false;
    int64_t isize = (int64_t)le32(in + off + bsize - 4);
    members.push_back({off, off + hlen, bsize - hlen - 8, out, isize});
    out += isize;
    off += bsize;
  }
  return true;
}

}  // namespace

extern "C" {

// Total decompressed size of a gzip/bgzf buffer, or -1 if unknowable
// cheaply. BGZF: sum of per-member ISIZE (exact). Single plain member:
// trailing ISIZE (valid while < 4 GiB — caller falls back on -2 from
// exon_gunzip if the guess was short).
int64_t exon_gzip_out_size(const uint8_t *in, int64_t n) {
  if (n < 18) return -1;
  int64_t bsize;
  if (parse_header(in, n, 0, &bsize) < 0) return -1;
  if (bsize > 0) {
    std::vector<Member> members;
    if (scan_bgzf(in, n, members)) {
      int64_t total = 0;
      for (auto &m : members) total += m.out_len;
      return total;
    }
    return -1;
  }
  return (int64_t)le32(in + n - 4);  // assume single member
}

// Decompress gzip/bgzf into out. Returns bytes written, -1 on corrupt
// input, -2 if out_cap is too small (caller should fall back / regrow).
int64_t exon_gunzip(const uint8_t *in, int64_t n, uint8_t *out,
                    int64_t out_cap, int32_t n_threads) {
  if (n < 18) return -1;
  std::vector<Member> members;
  int64_t bsize;
  if (parse_header(in, n, 0, &bsize) >= 0 && bsize > 0 &&
      scan_bgzf(in, n, members)) {
    int64_t total = 0;
    for (auto &m : members) total += m.out_len;
    if (total > out_cap) return -2;
    int nt = n_threads;
    int hw = (int)std::thread::hardware_concurrency();
    if (nt <= 0) nt = hw > 0 ? hw : 1;
    if ((size_t)nt > members.size()) nt = (int)members.size();
    std::atomic<size_t> next(0);
    std::atomic<int> failed(0);
    auto worker = [&]() {
      libdeflate_decompressor *d = libdeflate_alloc_decompressor();
      size_t i;
      while ((i = next.fetch_add(1)) < members.size()) {
        const Member &m = members[i];
        if (m.out_len == 0) continue;  // EOF marker block
        size_t got = 0;
        int rc = libdeflate_deflate_decompress(d, in + m.data_off,
                                               (size_t)m.data_len,
                                               out + m.out_off,
                                               (size_t)m.out_len, &got);
        if (rc != 0 || got != (size_t)m.out_len) failed.store(1);
      }
      libdeflate_free_decompressor(d);
    };
    if (nt <= 1) {
      worker();
    } else {
      std::vector<std::thread> ts;
      for (int t = 0; t < nt; t++) ts.emplace_back(worker);
      for (auto &t : ts) t.join();
    }
    return failed.load() ? -1 : total;
  }

  // generic (possibly multi-member) gzip: sequential libdeflate
  libdeflate_decompressor *d = libdeflate_alloc_decompressor();
  int64_t off = 0, written = 0;
  int64_t rc = 0;
  while (off < n) {
    if (n - off < 18) break;  // trailing garbage / padding: stop
    if (in[off] != 0x1f || in[off + 1] != 0x8b) break;
    size_t ain = 0, aout = 0;
    int r = libdeflate_gzip_decompress_ex(d, in + off, (size_t)(n - off),
                                          out + written,
                                          (size_t)(out_cap - written), &ain,
                                          &aout);
    if (r == 3 /* INSUFFICIENT_SPACE */) {
      rc = -2;
      break;
    }
    if (r != 0) {
      rc = -1;
      break;
    }
    off += (int64_t)ain;
    written += (int64_t)aout;
  }
  libdeflate_free_decompressor(d);
  return rc < 0 ? rc : written;
}

// BGZF block table: fills up to `max` (in_offset, in_size, out_size)
// triples. Returns the number of members in the buffer (may exceed max;
// call again with a bigger table), or -1 if not wholly BGZF.
int64_t exon_bgzf_blocks(const uint8_t *in, int64_t n, int64_t *in_off,
                         int64_t *in_size, int64_t *out_size, int64_t max) {
  std::vector<Member> members;
  if (!scan_bgzf(in, n, members)) return -1;
  int64_t count = (int64_t)members.size();
  for (int64_t i = 0; i < count && i < max; i++) {
    int64_t next_off = (i + 1 < count) ? members[i + 1].in_off : n;
    in_off[i] = members[i].in_off;
    in_size[i] = next_off - members[i].in_off;
    out_size[i] = members[i].out_len;
  }
  return count;
}

// BAM alignment-record offsets: hop block_size fields from `start`.
// Fills up to `max` offsets; returns the total record count (call again
// with a bigger table if it exceeds max), or -1 on a malformed length.
int64_t exon_bam_record_offsets(const uint8_t *data, int64_t n, int64_t start,
                                int64_t *out, int64_t max) {
  int64_t off = start, count = 0;
  while (off + 4 <= n) {
    int64_t bs = (int64_t)le32(data + off);
    if (bs < 32 || off + 4 + bs > n) {
      if (bs == 0 && off + 4 == n) break;  // trailing empty
      return -1;
    }
    if (count < max) out[count] = off;
    count++;
    off += 4 + bs;
  }
  return count;
}

// Per-record BAM alignment spans: ref_id, 1-based start, 1-based
// inclusive end (pos + CIGAR reference span), walking the packed CIGAR
// ops in one sequential pass. Replaces the numpy repeat/add.at walk on
// the indexed-scan row-filter path (SemiLazyRecord::alignment_end,
// exon-bam/src/indexed_async_batch_stream.rs:40-88). Two-thread split.
int64_t exon_bam_spans(const uint8_t *data, int64_t n, const int64_t *offsets,
                       int64_t count, int32_t *ref_id, int32_t *start,
                       int32_t *end, int32_t n_threads) {
  static const int64_t consumes_ref = 0x18D;  // bits for ops M D N = X
  std::atomic<int> bad(0);
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t body = offsets[i] + 4;
      if (body + 32 > n) { bad.store(1); return; }
      int32_t rid = (int32_t)le32(data + body);
      int32_t pos = (int32_t)le32(data + body + 4);
      uint8_t l_read_name = data[body + 8];
      uint16_t n_cigar = le16(data + body + 12);
      // truncated/corrupt record: CIGAR array must lie inside the buffer
      if (body + 32 + (int64_t)l_read_name + 4 * (int64_t)n_cigar > n) {
        bad.store(1);
        return;
      }
      const uint8_t *cig = data + body + 32 + l_read_name;
      int64_t span = 0;
      for (uint16_t c = 0; c < n_cigar; c++) {
        uint32_t op = le32(cig + 4 * c);
        if ((consumes_ref >> (op & 0xF)) & 1) span += op >> 4;
      }
      ref_id[i] = rid;
      start[i] = pos + 1;
      end[i] = pos + (int32_t)span;
    }
  };
  int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 1 && count > 65536) {
    int64_t half = count / 2;
    std::thread t(work, 0, half);
    work(half, count);
    t.join();
  } else {
    work(0, count);
  }
  return bad.load() ? -1 : count;
}

// Gather little-endian fixed-width ints at data[idx[i] + delta] — the
// field loads of BAM decode (numpy fancy-index gathers cost ~10x this).
// width: 1, 2, or 4 bytes; output widened to int32.
int64_t exon_gather_le(const uint8_t *data, int64_t n, const int64_t *idx,
                       int64_t count, int64_t delta, int32_t width,
                       int32_t *out) {
  // bounds-check every load (truncated/corrupt BAM): -1 sends the Python
  // caller to the checked numpy fancy-index path, which raises IndexError
  for (int64_t i = 0; i < count; i++) {
    int64_t p = idx[i] + delta;
    if (p < 0 || p + width > n) return -1;
  }
  switch (width) {
    case 1:
      for (int64_t i = 0; i < count; i++) out[i] = data[idx[i] + delta];
      break;
    case 2:
      for (int64_t i = 0; i < count; i++)
        out[i] = le16(data + idx[i] + delta);
      break;
    case 4:
      for (int64_t i = 0; i < count; i++)
        out[i] = (int32_t)le32(data + idx[i] + delta);
      break;
    default:
      return -1;
  }
  return count;
}

// Streaming zstd decompress (frames of unknown content size). Returns
// bytes written, -1 on error, -2 if out_cap too small.
int64_t exon_zstd_decompress(const uint8_t *in, int64_t n, uint8_t *out,
                             int64_t out_cap) {
  ZSTD_DCtx *ctx = ZSTD_createDCtx();
  if (!ctx) return -1;
  ZSTD_inBuffer ib{in, (size_t)n, 0};
  ZSTD_outBuffer ob{out, (size_t)out_cap, 0};
  int64_t rc = 0;
  while (ib.pos < ib.size) {
    size_t r = ZSTD_decompressStream(ctx, &ob, &ib);
    if (ZSTD_isError(r)) {
      rc = -1;
      break;
    }
    if (ob.pos == ob.size && ib.pos < ib.size) {
      rc = -2;  // out of space with input remaining
      break;
    }
  }
  ZSTD_freeDCtx(ctx);
  return rc < 0 ? rc : (int64_t)ob.pos;
}

}  // extern "C"
