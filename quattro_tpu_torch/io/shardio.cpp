// Native trajectory-log shard IO for quattro_tpu_torch.
//
// A copy of the JAX package's quattro_tpu/io/shardio.cpp, so that the port
// reads and writes the same files without importing that package. Framing,
// CRC validation, file scanning/indexing and shard merging run natively;
// Python (quattro_tpu_torch/io/shardio.py) only moves numpy buffers in and out.
//
// File format "QTSHRD01": a header magic followed by length-prefixed records.
//   file   := magic8 record*
//   magic8 := "QTSHRD01"
//   record := u32 rmagic (0x51545231 'QTR1') | u64 payload_len |
//             u32 crc32(payload) | payload bytes
// Integers are little-endian. Records are append-only, so a crashed writer
// loses at most its final partial record: the scanner stops at the first
// frame that fails to parse.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libqtshardio.so shardio.cpp
// Loaded via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kFileMagic[8] = {'Q', 'T', 'S', 'H', 'R', 'D', '0', '1'};
constexpr uint32_t kRecordMagic = 0x51545231u;  // 'QTR1'
constexpr size_t kHeaderSize = 4 + 8 + 4;

// CRC-32 (IEEE 802.3, same polynomial/parameters as zlib.crc32 so the pure
// Python fallback interoperates bit-for-bit).
uint32_t* crc_table() {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  return table;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  const uint32_t* table = crc_table();
  crc = ~crc;
  for (size_t i = 0; i < len; ++i) crc = table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8); p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}
void put_u64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = uint8_t(v >> (8 * i));
}
uint32_t get_u32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
uint64_t get_u64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

struct Writer {
  FILE* f = nullptr;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Writer API
// ---------------------------------------------------------------------------

// Open for append; writes the file magic if the file is new/empty.
// Returns an opaque handle or nullptr on failure.
void* qtshard_writer_open(const char* path) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return nullptr;
  // fseek to learn current size; "ab" positions at end on every write anyway.
  if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return nullptr; }
  long size = std::ftell(f);
  if (size == 0) {
    if (std::fwrite(kFileMagic, 1, 8, f) != 8) { std::fclose(f); return nullptr; }
  }
  Writer* w = new Writer();
  w->f = f;
  return w;
}

// Append one record. Returns 0 on success, nonzero on IO failure.
int qtshard_writer_append(void* handle, const uint8_t* payload, uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return 1;
  uint8_t header[kHeaderSize];
  put_u32(header, kRecordMagic);
  put_u64(header + 4, len);
  put_u32(header + 12, crc32_update(0, payload, size_t(len)));
  if (std::fwrite(header, 1, kHeaderSize, w->f) != kHeaderSize) return 2;
  if (len && std::fwrite(payload, 1, size_t(len), w->f) != size_t(len)) return 3;
  return 0;
}

// Flush buffered data to the OS. Returns 0 on success.
int qtshard_writer_flush(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return 1;
  return std::fflush(w->f) == 0 ? 0 : 2;
}

int qtshard_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return 1;
  int rc = w->f ? std::fclose(w->f) : 0;
  delete w;
  return rc == 0 ? 0 : 2;
}

// ---------------------------------------------------------------------------
// Scanner / index API
// ---------------------------------------------------------------------------

// Scan a shard file, CRC-validating every record. On success fills
// *out_offsets / *out_lengths (malloc'd, caller frees via qtshard_free) with
// the payload byte offset and length of each valid record and *out_count.
//
// Return codes: 0 ok; 1 cannot open; 2 bad file magic;
// 3 corrupt record (CRC mismatch) — index still returned, truncated at the
//   last valid record, *out_corrupt_offset says where corruption starts;
// 4 trailing partial record (clean crash tail) — treated like 3.
int qtshard_index(const char* path, uint64_t** out_offsets, uint64_t** out_lengths,
                  uint64_t* out_count, uint64_t* out_corrupt_offset) {
  *out_offsets = nullptr;
  *out_lengths = nullptr;
  *out_count = 0;
  *out_corrupt_offset = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  uint64_t file_size = uint64_t(std::ftell(f));
  std::fseek(f, 0, SEEK_SET);

  char magic[8];
  if (file_size < 8 || std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, kFileMagic, 8) != 0) {
    std::fclose(f);
    return 2;
  }

  std::vector<uint64_t> offsets, lengths;
  std::vector<uint8_t> buf;
  uint64_t pos = 8;
  int rc = 0;
  while (pos < file_size) {
    if (pos + kHeaderSize > file_size) { rc = 4; break; }
    uint8_t header[kHeaderSize];
    if (std::fread(header, 1, kHeaderSize, f) != kHeaderSize) { rc = 4; break; }
    if (get_u32(header) != kRecordMagic) { rc = 3; break; }
    uint64_t len = get_u64(header + 4);
    uint32_t want_crc = get_u32(header + 12);
    // Subtract-form bounds check: `pos + kHeaderSize + len > file_size`
    // wraps for a corrupt len near UINT64_MAX, passing the check and letting
    // buf.resize() throw through the extern "C" boundary (std::terminate).
    // Here pos + kHeaderSize <= file_size, so the RHS cannot underflow.
    if (len > file_size - pos - kHeaderSize) { rc = 4; break; }
    buf.resize(size_t(len));
    if (len && std::fread(buf.data(), 1, size_t(len), f) != size_t(len)) { rc = 4; break; }
    if (crc32_update(0, buf.data(), size_t(len)) != want_crc) { rc = 3; break; }
    offsets.push_back(pos + kHeaderSize);
    lengths.push_back(len);
    pos += kHeaderSize + len;
  }
  if (rc != 0) *out_corrupt_offset = pos;
  std::fclose(f);

  uint64_t n = offsets.size();
  if (n) {
    *out_offsets = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
    *out_lengths = static_cast<uint64_t*>(std::malloc(n * sizeof(uint64_t)));
    if (!*out_offsets || !*out_lengths) {
      std::free(*out_offsets); std::free(*out_lengths);
      *out_offsets = *out_lengths = nullptr;
      return 5;
    }
    std::memcpy(*out_offsets, offsets.data(), n * sizeof(uint64_t));
    std::memcpy(*out_lengths, lengths.data(), n * sizeof(uint64_t));
  }
  *out_count = n;
  return rc;
}

void qtshard_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Merge API — the reference's combine_logs_sequentially equivalent
// (training_data_collection.py:265-290), but validated and without the
// intermediate Python object churn: records stream file→file natively.
// ---------------------------------------------------------------------------

// Append every valid record of src onto dst (creating dst if needed).
// Returns the number of records merged, or a negative error code:
// -1 src unreadable/bad magic, -2 dst unwritable, -3 IO error mid-copy.
// Corrupt tails in src are skipped silently (matching the reference's
// missing-file tolerance during merge).
int64_t qtshard_merge(const char* dst, const char* src) {
  uint64_t *offs = nullptr, *lens = nullptr, count = 0, corrupt = 0;
  int rc = qtshard_index(src, &offs, &lens, &count, &corrupt);
  if (rc == 1 || rc == 2 || rc == 5) { qtshard_free(offs); qtshard_free(lens); return -1; }

  void* w = qtshard_writer_open(dst);
  if (!w) { qtshard_free(offs); qtshard_free(lens); return -2; }

  FILE* f = std::fopen(src, "rb");
  if (!f) { qtshard_writer_close(w); qtshard_free(offs); qtshard_free(lens); return -1; }

  std::vector<uint8_t> buf;
  int64_t merged = 0;
  for (uint64_t i = 0; i < count; ++i) {
    buf.resize(size_t(lens[i]));
    if (std::fseek(f, long(offs[i]), SEEK_SET) != 0 ||
        (lens[i] && std::fread(buf.data(), 1, size_t(lens[i]), f) != size_t(lens[i])) ||
        qtshard_writer_append(w, buf.data(), lens[i]) != 0) {
      merged = -3;
      break;
    }
    ++merged;
  }
  std::fclose(f);
  qtshard_writer_close(w);
  qtshard_free(offs);
  qtshard_free(lens);
  return merged;
}

}  // extern "C"
