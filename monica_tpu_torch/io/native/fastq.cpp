// Native host-side ingest: FASTQ record indexing, base encoding and the
// 2-bit wire pack.
//
// A single linear scan over the raw buffer produces record/id/sequence
// byte spans, and a vectorized encoder fills padded uint8 code matrices
// directly.  Exposed extern "C" for ctypes; the pure-Python fallback is
// monica_tpu_torch/io/seq.py.  Up to pack_2bit, the same source as the
// JAX package's monica_tpu/io/native/fastq.cpp; pack_2bit's numpy
// fallback is monica_tpu_torch/io/encode.py:pack_codes_2bit.
//
// Build: see monica_tpu_torch/io/native/__init__.py (g++ -O3 -shared
// -fPIC, at first use, into the port's build directory).

#include <cstdint>
#include <cstring>

extern "C" {

// Single pass over a FASTQ buffer.  For each record i < max_records:
//   rec_off/rec_len  : full record byte span (all 4 lines, incl. final \n)
//   id_off/id_len    : read id (after '@', up to first space or EOL)
//   seq_off/seq_len  : sequence line span
// Returns the number of records found, or -(byte offset)-1 on a
// malformed record.  Records beyond max_records are not scanned.
int64_t fastq_index(const char* buf, int64_t n,
                    int64_t max_records,
                    int64_t* rec_off, int64_t* rec_len,
                    int64_t* id_off, int32_t* id_len,
                    int64_t* seq_off, int32_t* seq_len) {
  int64_t i = 0, r = 0;
  while (i < n && r < max_records) {
    // skip blank lines between records
    while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
    if (i >= n) break;
    if (buf[i] != '@') return -i - 1;
    int64_t start = i;
    // header line
    int64_t id0 = i + 1;
    while (i < n && buf[i] != '\n') i++;
    int64_t hdr_end = i;
    int64_t ide = id0;
    while (ide < hdr_end && buf[ide] != ' ' && buf[ide] != '\t' && buf[ide] != '\r') ide++;
    if (i < n) i++;  // consume \n
    // sequence line
    int64_t s0 = i;
    while (i < n && buf[i] != '\n') i++;
    int64_t se = i;
    while (se > s0 && buf[se - 1] == '\r') se--;
    if (i < n) i++;
    // plus line
    if (i >= n || buf[i] != '+') return -i - 1;
    while (i < n && buf[i] != '\n') i++;
    if (i < n) i++;
    // quality line (same length as sequence; tolerate shorter at EOF)
    while (i < n && buf[i] != '\n') i++;
    if (i < n) i++;
    rec_off[r] = start;
    rec_len[r] = i - start;
    id_off[r] = id0;
    id_len[r] = (int32_t)(ide - id0);
    seq_off[r] = s0;
    seq_len[r] = (int32_t)(se - s0);
    r++;
  }
  return r;
}

// Count records without filling spans (for exact allocation).
int64_t fastq_count(const char* buf, int64_t n) {
  int64_t i = 0, r = 0;
  while (i < n) {
    while (i < n && (buf[i] == '\n' || buf[i] == '\r')) i++;
    if (i >= n) break;
    if (buf[i] != '@') return -i - 1;
    for (int line = 0; line < 4; ++line) {
      while (i < n && buf[i] != '\n') i++;
      if (i < n) i++;
    }
    r++;
  }
  return r;
}

// Encode selected reads into a pre-filled padded matrix:
// out[row, :seq_len] = code(buf[seq_off .. ]), truncated at row_len.
// rows indexes out; codes: A/a=0 C/c=1 G/g=2 T/t=3 else 4.
void encode_rows(const char* buf,
                 const int64_t* seq_off, const int32_t* seq_len,
                 const int64_t* rows, int64_t n_rows,
                 uint8_t* out, int64_t row_stride, int32_t row_len) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 4, sizeof(lut));
    lut[(unsigned)'A'] = lut[(unsigned)'a'] = 0;
    lut[(unsigned)'C'] = lut[(unsigned)'c'] = 1;
    lut[(unsigned)'G'] = lut[(unsigned)'g'] = 2;
    lut[(unsigned)'T'] = lut[(unsigned)'t'] = 3;
    init = true;
  }
  for (int64_t k = 0; k < n_rows; ++k) {
    const char* src = buf + seq_off[k];
    int32_t m = seq_len[k] < row_len ? seq_len[k] : row_len;
    uint8_t* dst = out + rows[k] * row_stride;
    for (int32_t j = 0; j < m; ++j) dst[j] = lut[(unsigned char)src[j]];
  }
}

// Concatenate selected raw record spans into one output buffer
// (batched routing: unmapped/ambiguous/focus FASTQ writes become one
// buffer build + one fwrite instead of a per-read Python loop).
void concat_records(const char* buf,
                    const int64_t* rec_off, const int64_t* rec_len,
                    const int64_t* sel, int64_t n, char* out) {
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = sel[i];
    memcpy(out + o, buf + rec_off[r], (size_t)rec_len[r]);
    o += rec_len[r];
  }
}

// Same, replacing each record's read id with new_id (the mapped-route
// tax-unit rewrite, reference aligner.py:242).  Output size per record
// is rec_len - id_len + new_id_len.
void concat_records_with_id(const char* buf,
                            const int64_t* rec_off, const int64_t* rec_len,
                            const int64_t* id_off, const int32_t* id_len,
                            const int64_t* sel, int64_t n,
                            const char* new_id, int32_t new_id_len,
                            char* out) {
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = sel[i];
    int64_t pre = id_off[r] - rec_off[r];
    memcpy(out + o, buf + rec_off[r], (size_t)pre);
    o += pre;
    memcpy(out + o, new_id, (size_t)new_id_len);
    o += new_id_len;
    int64_t post = rec_len[r] - pre - id_len[r];
    memcpy(out + o, buf + id_off[r] + id_len[r], (size_t)post);
    o += post;
  }
}

// Pack (n_rows, row_len) uint8 codes into the 2-bit wire, (n_rows,
// ceil(row_len / 4)) bytes, both C-contiguous: base i in bits 2*(i % 4)
// of byte i / 4, every code >= 4 (N, PAD) as 0, a short tail byte
// zero-filled.  One pass, no temporaries, on the caller's thread.  The
// inner loop vectorises at -O3; on x86-64 an AVX2 clone, picked at load
// time where the CPU has AVX2, doubles the vector width.
#if defined(__x86_64__)
__attribute__((target_clones("avx2", "default")))
#endif
void pack_2bit(const uint8_t* __restrict codes, int64_t n_rows, int64_t row_len,
               uint8_t* __restrict out) {
  const int64_t full = row_len / 4, out_len = (row_len + 3) / 4;
  for (int64_t r = 0; r < n_rows; ++r) {
    const uint8_t* src = codes + r * row_len;
    uint8_t* dst = out + r * out_len;
    for (int64_t j = 0; j < full; ++j) {
      uint8_t a = src[4 * j], b = src[4 * j + 1], c = src[4 * j + 2], d = src[4 * j + 3];
      a = a < 4 ? a : 0;
      b = b < 4 ? b : 0;
      c = c < 4 ? c : 0;
      d = d < 4 ? d : 0;
      dst[j] = (uint8_t)(a | (b << 2) | (c << 4) | (d << 6));
    }
    if (full < out_len) {
      uint8_t t = 0;
      for (int64_t i = 4 * full; i < row_len; ++i)
        t |= (uint8_t)((src[i] < 4 ? src[i] : 0) << (2 * (i - 4 * full)));
      dst[full] = t;
    }
  }
}

}  // extern "C"
