// Native FASTA scanner: single-pass decode of record structure.
//
// The engine's host-side ingest kernel (the role noodles' Rust parsers
// play in the reference, exon-fasta/src/batch_reader.rs) — one pass over the
// buffer produces, per record:
//   * header start/end offsets (name/description split at first space)
//   * sequence prefix bytes (first K, newline-spliced) + true length
//   * (full mode) compacted sequence bytes + offsets
//
// Exposed via a plain C ABI for ctypes. Build: see native/build.sh.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" {

struct FastaIndex {
  int64_t n_records;
  // per record, arrays of length n_records (+1 for offsets)
  int64_t* header_start;   // offset of '>'
  int64_t* name_start;     // after '>'
  int64_t* name_end;       // first space or line end
  int64_t* desc_start;     // after first space (== desc_end if none)
  int64_t* desc_end;       // header line end (no \r)
  int64_t* seq_length;     // true sequence length (newlines removed)
};

// Count '>' line starts (cheap pre-pass to size allocations).
int64_t fasta_count_records(const uint8_t* data, int64_t n) {
  int64_t count = 0;
  if (n == 0) return 0;
  if (data[0] == '>') count++;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
    p++;
    if (p < end && *p == '>') count++;
  }
  return count;
}

// Single-pass structural scan. Caller allocates arrays sized by
// fasta_count_records. Returns number of records written, or -1 on error.
int64_t fasta_scan(const uint8_t* data, int64_t n, FastaIndex* idx,
                   uint8_t* prefix_out, int64_t prefix_k) {
  int64_t rec = -1;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  int64_t cur_len = 0;
  int64_t cur_prefix = 0;

  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* line_end = nl ? nl : end;
    const uint8_t* content_end = line_end;
    if (content_end > p && content_end[-1] == '\r') content_end--;

    if (*p == '>') {
      // close previous record
      if (rec >= 0) idx->seq_length[rec] = cur_len;
      rec++;
      cur_len = 0;
      cur_prefix = 0;
      idx->header_start[rec] = p - data;
      const uint8_t* sp =
          (const uint8_t*)memchr(p + 1, ' ', content_end - (p + 1));
      idx->name_start[rec] = (p + 1) - data;
      if (sp) {
        idx->name_end[rec] = sp - data;
        idx->desc_start[rec] = (sp + 1) - data;
        idx->desc_end[rec] = content_end - data;
      } else {
        idx->name_end[rec] = content_end - data;
        idx->desc_start[rec] = content_end - data;
        idx->desc_end[rec] = content_end - data;
      }
    } else if (rec >= 0) {
      int64_t line_len = content_end - p;
      if (cur_prefix < prefix_k && line_len > 0) {
        int64_t take = prefix_k - cur_prefix;
        if (take > line_len) take = line_len;
        memcpy(prefix_out + rec * prefix_k + cur_prefix, p, (size_t)take);
        cur_prefix += take;
      }
      cur_len += line_len;
    } else if (content_end > p) {
      return -1;  // sequence data before first header
    }
    p = nl ? nl + 1 : end;
  }
  if (rec >= 0) idx->seq_length[rec] = cur_len;
  return rec + 1;
}

// Full-materialization pass: copy sequence bytes (newline-free) into out,
// using seq_offsets computed from seq_length (exclusive prefix sum, caller
// provides). Returns total bytes written or -1.
int64_t fasta_fill_sequences(const uint8_t* data, int64_t n,
                             const int64_t* header_start, int64_t n_records,
                             const int64_t* seq_offsets, uint8_t* out) {
  int64_t rec = -1;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  uint8_t* w = out;

  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* line_end = nl ? nl : end;
    const uint8_t* content_end = line_end;
    if (content_end > p && content_end[-1] == '\r') content_end--;

    if (*p == '>') {
      rec++;
      if (rec < n_records) w = out + seq_offsets[rec];
    } else if (rec >= 0 && content_end > p) {
      memcpy(w, p, (size_t)(content_end - p));
      w += content_end - p;
    }
    p = nl ? nl + 1 : end;
  }
  return w - out;
}

// --------------------------------------------------------------------------
// Multithreaded FASTA scan: split the buffer at record ('\n>') boundaries,
// count + scan each shard in parallel, write shard s's records at the
// shard's global record offset. Host ingest is the engine's noodles-analog
// hot loop; threads keep host decode ahead of the device.

static int64_t next_record_boundary(const uint8_t* data, int64_t n,
                                    int64_t from) {
  if (from <= 0) return 0;
  const uint8_t* p = data + from - 1;
  const uint8_t* end = data + n;
  while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
    p++;
    if (p >= end) break;
    if (*p == '>') return p - data;
  }
  return n;
}

int64_t fasta_count_records_mt(const uint8_t* data, int64_t n,
                               int64_t n_threads) {
  if (n_threads < 2 || n < (4 << 20)) return fasta_count_records(data, n);
  std::vector<int64_t> bounds(n_threads + 1);
  bounds[0] = 0;
  for (int64_t t = 1; t < n_threads; t++)
    bounds[t] = next_record_boundary(data, n, t * (n / n_threads));
  bounds[n_threads] = n;
  std::vector<int64_t> counts(n_threads, 0);
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t] {
      counts[t] = fasta_count_records(data + bounds[t],
                                      bounds[t + 1] - bounds[t]);
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto c : counts) total += c;
  return total;
}

int64_t fasta_scan_mt(const uint8_t* data, int64_t n, FastaIndex* idx,
                      uint8_t* prefix_out, int64_t prefix_k,
                      int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n < (4 << 20)) {
    return fasta_scan(data, n, idx, prefix_out, prefix_k);
  }
  std::vector<int64_t> bounds(n_threads + 1);
  bounds[0] = 0;
  for (int64_t t = 1; t < n_threads; t++) {
    bounds[t] = next_record_boundary(data, n, t * (n / n_threads));
  }
  bounds[n_threads] = n;
  // leading bytes before the first '>' are an error unless whitespace-only
  if (n > 0 && data[0] != '>') {
    const uint8_t* q = data;
    while (q < data + n && (*q == '\n' || *q == '\r')) q++;
    if (q < data + n && *q != '>') return -1;
    bounds[0] = next_record_boundary(data, n, 1);
  }
  std::vector<int64_t> counts(n_threads, 0);
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < n_threads; t++) {
      threads.emplace_back([&, t] {
        counts[t] = fasta_count_records(data + bounds[t],
                                        bounds[t + 1] - bounds[t]);
      });
    }
    for (auto& th : threads) th.join();
  }
  std::vector<int64_t> rec_off(n_threads + 1, 0);
  for (int64_t t = 0; t < n_threads; t++)
    rec_off[t + 1] = rec_off[t] + counts[t];
  std::vector<int64_t> written(n_threads, 0);
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < n_threads; t++) {
      threads.emplace_back([&, t] {
        FastaIndex sub;
        int64_t off = rec_off[t];
        sub.header_start = idx->header_start + off;
        sub.name_start = idx->name_start + off;
        sub.name_end = idx->name_end + off;
        sub.desc_start = idx->desc_start + off;
        sub.desc_end = idx->desc_end + off;
        sub.seq_length = idx->seq_length + off;
        written[t] = fasta_scan(data + bounds[t], bounds[t + 1] - bounds[t],
                                &sub, prefix_out + off * prefix_k, prefix_k);
        // shard-local offsets → global
        if (written[t] > 0 && bounds[t] != 0) {
          for (int64_t i = 0; i < written[t]; i++) {
            sub.header_start[i] += bounds[t];
            sub.name_start[i] += bounds[t];
            sub.name_end[i] += bounds[t];
            sub.desc_start[i] += bounds[t];
            sub.desc_end[i] += bounds[t];
          }
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (int64_t t = 0; t < n_threads; t++) {
    if (written[t] < 0) return -1;
    total += written[t];
  }
  return total;
}

// Single-count-pass API: compute shard bounds + per-shard record counts in
// one parallel pass. Caller sizes output arrays from the returned total and
// then calls fasta_scan_mt_counted, which skips the redundant count pass —
// the whole scan touches the buffer twice instead of three times (matters:
// the 2-core host runs memchr at ~2 GB/s/core, so every pass is ~60 ms on
// a 250 MB file).
int64_t fasta_shard_bounds(const uint8_t* data, int64_t n, int64_t n_threads,
                           int64_t* bounds_out, int64_t* counts_out) {
  if (n_threads < 1) n_threads = 1;
  bounds_out[0] = 0;
  for (int64_t t = 1; t < n_threads; t++)
    bounds_out[t] = next_record_boundary(data, n, t * (n / n_threads));
  bounds_out[n_threads] = n;
  if (n > 0 && data[0] != '>') {
    const uint8_t* q = data;
    while (q < data + n && (*q == '\n' || *q == '\r')) q++;
    if (q < data + n && *q != '>') return -1;
    bounds_out[0] = next_record_boundary(data, n, 1);
  }
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t] {
      counts_out[t] = fasta_count_records(data + bounds_out[t],
                                          bounds_out[t + 1] - bounds_out[t]);
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t t = 0; t < n_threads; t++) total += counts_out[t];
  return total;
}

// Scan using shard bounds/counts from fasta_shard_bounds (ONE data pass).
int64_t fasta_scan_mt_counted(const uint8_t* data, int64_t n,
                              FastaIndex* idx, uint8_t* prefix_out,
                              int64_t prefix_k, int64_t n_threads,
                              const int64_t* bounds,
                              const int64_t* counts) {
  std::vector<int64_t> rec_off(n_threads + 1, 0);
  for (int64_t t = 0; t < n_threads; t++)
    rec_off[t + 1] = rec_off[t] + counts[t];
  std::vector<int64_t> written(n_threads, 0);
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < n_threads; t++) {
      threads.emplace_back([&, t] {
        FastaIndex sub;
        int64_t off = rec_off[t];
        sub.header_start = idx->header_start + off;
        sub.name_start = idx->name_start + off;
        sub.name_end = idx->name_end + off;
        sub.desc_start = idx->desc_start + off;
        sub.desc_end = idx->desc_end + off;
        sub.seq_length = idx->seq_length + off;
        written[t] = fasta_scan(data + bounds[t], bounds[t + 1] - bounds[t],
                                &sub, prefix_out + off * prefix_k, prefix_k);
        if (written[t] > 0 && bounds[t] != 0) {
          for (int64_t i = 0; i < written[t]; i++) {
            sub.header_start[i] += bounds[t];
            sub.name_start[i] += bounds[t];
            sub.name_end[i] += bounds[t];
            sub.desc_start[i] += bounds[t];
            sub.desc_end[i] += bounds[t];
          }
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (int64_t t = 0; t < n_threads; t++) {
    if (written[t] < 0) return -1;
    total += written[t];
  }
  return total;
}

// --------------------------------------------------------------------------
// TRUE single-pass scan: no pre-count. Each thread scans its shard into
// thread-local growable buffers; results are stitched with one memcpy per
// array (~30 MB total — ~10 ms vs ~60 ms for a count pass over 250 MB).
// Output arrays are malloc'd here; caller copies and calls
// fasta_scan_result_free.

struct FastaScanResult {
  int64_t n_records;
  int64_t* header_start;
  int64_t* name_start;
  int64_t* name_end;
  int64_t* desc_start;
  int64_t* desc_end;
  int64_t* seq_length;
  uint8_t* prefix;  // [n_records * prefix_k], zero-filled tails
  int64_t error;    // 0 ok; -1 data before first header
};

namespace {

struct ShardVecs {
  std::vector<int64_t> header_start, name_start, name_end, desc_start,
      desc_end, seq_length;
  std::vector<uint8_t> prefix;
  int64_t base = 0;  // shard offset in the file
  int64_t error = 0;
};

static void scan_shard(const uint8_t* data, int64_t n, int64_t prefix_k,
                       ShardVecs* out) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  int64_t cur_len = 0;
  int64_t cur_prefix = 0;
  bool in_rec = false;

  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* line_end = nl ? nl : end;
    const uint8_t* content_end = line_end;
    if (content_end > p && content_end[-1] == '\r') content_end--;

    if (*p == '>') {
      if (in_rec) out->seq_length.push_back(cur_len);
      in_rec = true;
      cur_len = 0;
      cur_prefix = 0;
      out->header_start.push_back((p - data) + out->base);
      const uint8_t* sp =
          (const uint8_t*)memchr(p + 1, ' ', content_end - (p + 1));
      out->name_start.push_back((p + 1 - data) + out->base);
      if (sp) {
        out->name_end.push_back((sp - data) + out->base);
        out->desc_start.push_back((sp + 1 - data) + out->base);
        out->desc_end.push_back((content_end - data) + out->base);
      } else {
        out->name_end.push_back((content_end - data) + out->base);
        out->desc_start.push_back((content_end - data) + out->base);
        out->desc_end.push_back((content_end - data) + out->base);
      }
      if (prefix_k > 0) out->prefix.resize(out->prefix.size() + prefix_k, 0);
    } else if (in_rec) {
      int64_t line_len = content_end - p;
      if (cur_prefix < prefix_k && line_len > 0) {
        int64_t take = prefix_k - cur_prefix;
        if (take > line_len) take = line_len;
        memcpy(out->prefix.data() + out->prefix.size() - prefix_k + cur_prefix,
               p, (size_t)take);
        cur_prefix += take;
      }
      cur_len += line_len;
    } else if (content_end > p) {
      out->error = -1;
      return;
    }
    p = nl ? nl + 1 : end;
  }
  if (in_rec) out->seq_length.push_back(cur_len);
}

}  // namespace

int64_t fasta_scan_onepass(const uint8_t* data, int64_t n, int64_t prefix_k,
                           int64_t n_threads, FastaScanResult* res) {
  if (n_threads < 1) n_threads = 1;
  if (n < (4 << 20)) n_threads = 1;
  std::vector<int64_t> bounds(n_threads + 1);
  bounds[0] = 0;
  for (int64_t t = 1; t < n_threads; t++)
    bounds[t] = next_record_boundary(data, n, t * (n / n_threads));
  bounds[n_threads] = n;
  if (n > 0 && data[0] != '>') {
    const uint8_t* q = data;
    while (q < data + n && (*q == '\n' || *q == '\r')) q++;
    if (q < data + n && *q != '>') {
      res->error = -1;
      res->n_records = 0;
      return -1;
    }
    bounds[0] = next_record_boundary(data, n, 1);
  }
  std::vector<ShardVecs> shards(n_threads);
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < n_threads; t++) {
      shards[t].base = bounds[t];
      int64_t est = (bounds[t + 1] - bounds[t]) / 256 + 16;
      shards[t].header_start.reserve(est);
      shards[t].name_start.reserve(est);
      shards[t].name_end.reserve(est);
      shards[t].desc_start.reserve(est);
      shards[t].desc_end.reserve(est);
      shards[t].seq_length.reserve(est);
      if (prefix_k > 0) shards[t].prefix.reserve(est * prefix_k);
      threads.emplace_back([&, t] {
        scan_shard(data + bounds[t], bounds[t + 1] - bounds[t], prefix_k,
                   &shards[t]);
      });
    }
    for (auto& th : threads) th.join();
  }
  int64_t total = 0;
  for (auto& s : shards) {
    if (s.error) {
      res->error = s.error;
      res->n_records = 0;
      return s.error;
    }
    total += (int64_t)s.header_start.size();
  }
  res->n_records = total;
  res->error = 0;
  res->header_start = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->name_start = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->name_end = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->desc_start = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->desc_end = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->seq_length = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
  res->prefix = prefix_k > 0
      ? (uint8_t*)malloc((size_t)(total ? total : 1) * prefix_k)
      : nullptr;
  int64_t off = 0;
  for (auto& s : shards) {
    int64_t c = (int64_t)s.header_start.size();
    if (!c) continue;
    memcpy(res->header_start + off, s.header_start.data(), c * 8);
    memcpy(res->name_start + off, s.name_start.data(), c * 8);
    memcpy(res->name_end + off, s.name_end.data(), c * 8);
    memcpy(res->desc_start + off, s.desc_start.data(), c * 8);
    memcpy(res->desc_end + off, s.desc_end.data(), c * 8);
    memcpy(res->seq_length + off, s.seq_length.data(), c * 8);
    if (prefix_k > 0)
      memcpy(res->prefix + off * prefix_k, s.prefix.data(),
             (size_t)c * prefix_k);
    off += c;
  }
  return total;
}

void fasta_scan_result_free(FastaScanResult* res) {
  free(res->header_start);
  free(res->name_start);
  free(res->name_end);
  free(res->desc_start);
  free(res->desc_end);
  free(res->seq_length);
  free(res->prefix);
}

// Integer-encode DNA in place over a byte buffer (A,C,G,T,N → 1..5).
// Returns index of first invalid byte, or -1 if all valid.
int64_t encode_dna(uint8_t* buf, int64_t n) {
  static int8_t table[256];
  static bool init = false;
  if (!init) {
    memset(table, 0, sizeof(table));
    table['A'] = 1; table['C'] = 2; table['G'] = 3; table['T'] = 4;
    table['N'] = 5;
    init = true;
  }
  for (int64_t i = 0; i < n; i++) {
    int8_t v = table[buf[i]];
    if (v == 0) return i;
    buf[i] = (uint8_t)v;
  }
  return -1;
}

// --------------------------------------------------------------------------
// Generic line-structure scan shared by TSV formats: emit line start/end
// offsets, skipping lines that begin with `comment` (0 = keep all).
int64_t scan_lines(const uint8_t* data, int64_t n, uint8_t comment,
                   int64_t* starts, int64_t* ends, int64_t max_lines) {
  int64_t count = 0;
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  while (p < end && count < max_lines) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* line_end = nl ? nl : end;
    const uint8_t* content_end = line_end;
    if (content_end > p && content_end[-1] == '\r') content_end--;
    if (content_end > p && (comment == 0 || *p != comment)) {
      starts[count] = p - data;
      ends[count] = content_end - data;
      count++;
    }
    p = nl ? nl + 1 : end;
  }
  return count;
}

}  // extern "C"
