// A Zstandard frame decoder (RFC 8878), host code with a plain C interface for ctypes.
//
// The orbax checkpoints the JAX package writes keep every B-tree node, manifest and array chunk as a zstd frame
// (tensorstore's OCDBT store and zarr's "zstd" compressor).  This decodes them without libzstd:
//
//   frames      several concatenated frames and skippable frames; the frame header with or without a content
//               size, single-segment or with a window descriptor, dictionary id 0 only; the XXH64 content
//               checksum, verified when present;
//   blocks      raw, RLE and compressed;
//   literals    raw, RLE, Huffman-coded in one or four streams, and treeless (the previous Huffman table);
//   sequences   FSE tables in predefined, RLE, compressed and repeat modes, the three repeat offsets.
//
// The whole output stays in the caller's buffer, so a match may reach back to the start of its frame: every
// window a frame declares fits.  Every read and write is bounds-checked; a malformed frame returns a negative
// error code and never reads or writes outside the buffers it was given.
//
//   int64_t goalnet_zstd_content_size(src, n)   the decoded size of every frame in src when all headers state
//                                               it; -1 when one does not; < -1 on error
//   int64_t goalnet_zstd_decode(src, n, dst, cap)  decode every frame into dst; the bytes written or < 0

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

enum Error : int64_t {
  kUnknown = -1,       // content size not stated (goalnet_zstd_content_size only)
  kCorrupt = -2,       // the data breaks the format
  kDstTooSmall = -3,   // the output does not fit the caller's buffer
  kChecksum = -4,      // the content checksum does not match
  kTruncated = -5,     // the input ends inside a frame
  kUnsupported = -6,   // a dictionary, or a reserved bit set
  kEmpty = -7,         // no frame at all
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }   // v > 0

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, load64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(load32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ bit readers

// Forward reader over a byte range (FSE table descriptions); reads past the end give zeros and set `over`.
struct ForwardBits {
  const uint8_t* src;
  size_t size;
  size_t pos = 0;   // in bits
  bool over = false;
  uint32_t peek(int n) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i)
      if (byte + i < size) v |= uint64_t(src[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) {
    pos += n;
    if (pos > size * 8) over = true;
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Backward reader (Huffman streams, FSE bitstreams): the stream is read from its last byte, whose highest set bit
// marks the start.  As zstd's BIT_DStream: a 64-bit window at `ptr`, `consumed` bits of it already read.
struct BackBits {
  const uint8_t* start = nullptr;
  const uint8_t* ptr = nullptr;
  uint64_t window = 0;
  unsigned consumed = 0;

  bool init(const uint8_t* src, size_t size) {
    if (size == 0) return false;
    uint8_t last = src[size - 1];
    if (last == 0) return false;   // no start marker
    start = src;
    if (size >= 8) {
      ptr = src + size - 8;
      window = load64(ptr);
      consumed = 8 - highbit32(last);
    } else {
      ptr = src;
      window = 0;
      for (size_t i = 0; i < size; ++i) window |= uint64_t(src[i]) << (8 * i);
      consumed = 8 - highbit32(last) + unsigned(8 - size) * 8;
    }
    return true;
  }
  inline uint64_t look(unsigned n) const {   // n <= 56 after a reload
    return ((window << (consumed & 63)) >> 1) >> (63 - n);
  }
  inline uint64_t read(unsigned n) {
    uint64_t v = look(n);
    consumed += n;
    return v;
  }
  // true while bits remain to be loaded or the window still holds unread bits; false once overread
  inline bool reload() {
    if (consumed > 64) return false;   // overflow: more bits read than the stream holds
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      window = load64(ptr);
      return true;
    }
    if (ptr == start) return true;
    size_t nb = consumed >> 3;
    if (size_t(ptr - start) < nb) nb = size_t(ptr - start);
    ptr -= nb;
    consumed -= unsigned(nb) * 8;
    window = load64(ptr);
    return true;
  }
  bool overflowed() const { return consumed > 64; }
  bool finished() const { return ptr == start && consumed == 64; }
};

// ------------------------------------------------------------------ FSE

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  FseEntry cell[1 << 9];
};

// A normalized distribution (`norm[s]`, -1 for "less than 1") of accuracy `log` → its decoding table.
bool fse_build(FseTable& t, const int16_t* norm, int max_symbol, int log) {
  const int size = 1 << log;
  uint16_t next[256];
  int high = size - 1;
  for (int s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      t.cell[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cell[pos].symbol = uint16_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) return false;   // the probabilities do not fill the table
  for (int u = 0; u < size; ++u) {
    int s = t.cell[u].symbol;
    uint32_t state = next[s]++;
    int bits = log - highbit32(state);
    t.cell[u].bits = uint8_t(bits);
    t.cell[u].base = uint16_t((state << bits) - size);
  }
  t.log = log;
  return true;
}

void fse_rle(FseTable& t, int symbol) {
  t.log = 0;
  t.cell[0] = FseEntry{uint16_t(symbol), 0, 0};
}

// Reads an FSE table description (RFC 8878 §4.1.1) → the bytes it took, or < 0.
int64_t fse_read_description(FseTable& t, const uint8_t* src, size_t size, int max_symbol, int max_log) {
  ForwardBits br{src, size};
  int log = int(br.read(4)) + 5;
  if (log > max_log) return kCorrupt;
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, symbol = 0;
  bool previous_zero = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous_zero) {
      int n0 = symbol;
      uint32_t r;
      do {
        r = br.read(2);
        n0 += int(r);
      } while (r == 3 && !br.over);
      if (n0 > max_symbol) return kCorrupt;
      while (symbol < n0) norm[symbol++] = 0;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      br.skip(nbits - 1);
    } else {
      count = int(br.peek(nbits));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;   // the stored value is the probability plus one
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous_zero = count == 0;
    while (remaining < threshold && nbits > 1) {
      --nbits;
      threshold >>= 1;
    }
    if (br.over) return kCorrupt;
  }
  if (remaining != 1 || br.over) return kCorrupt;
  if (!fse_build(t, norm, symbol - 1, log)) return kCorrupt;
  return int64_t(br.bytes_used());
}

inline uint16_t fse_init(const FseTable& t, BackBits& br) { return uint16_t(br.read(unsigned(t.log))); }
inline uint16_t fse_update(const FseTable& t, uint16_t state, BackBits& br) {
  const FseEntry& e = t.cell[state];
  return uint16_t(e.base + br.read(e.bits));
}

// ------------------------------------------------------------------ Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
  int bits = 0;   // 0: no table yet
  uint8_t symbol[1 << kHufMaxBits];
  uint8_t length[1 << kHufMaxBits];
};

// The Huffman tree description (RFC 8878 §4.2.1) → the bytes it took, or < 0.
int64_t huf_read_table(HufTable& h, const uint8_t* src, size_t size) {
  if (size < 1) return kCorrupt;
  uint8_t weight[256] = {0};
  int n = 0;
  size_t used;
  const int header = src[0];
  if (header >= 128) {   // direct: 4 bits a weight
    n = header - 127;
    used = 1 + size_t((n + 1) / 2);
    if (used > size) return kCorrupt;
    for (int i = 0; i < n; ++i) {
      uint8_t b = src[1 + i / 2];
      weight[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {   // FSE-compressed weights, two interleaved states
    used = 1 + size_t(header);
    if (used > size || header == 0) return kCorrupt;
    FseTable t;
    int64_t d = fse_read_description(t, src + 1, header, 255, 6);
    if (d < 0) return d;
    BackBits br;
    if (!br.init(src + 1 + d, size_t(header - d))) return kCorrupt;
    uint16_t s1 = fse_init(t, br), s2 = fse_init(t, br);
    const FseEntry* c = t.cell;
    for (;;) {   // as zstd's FSE tail loop: on overread, the other state's symbol is the last
      if (n > 253) return kCorrupt;
      weight[n++] = uint8_t(c[s1].symbol);
      s1 = fse_update(t, s1, br);
      if (!br.reload()) {
        weight[n++] = uint8_t(c[s2].symbol);
        break;
      }
      if (n > 253) return kCorrupt;
      weight[n++] = uint8_t(c[s2].symbol);
      s2 = fse_update(t, s2, br);
      if (!br.reload()) {
        weight[n++] = uint8_t(c[s1].symbol);
        break;
      }
    }
  }
  // the last weight is implied: it completes the sum of 2^(w-1) to a power of two
  uint32_t total = 0;
  for (int i = 0; i < n; ++i) {
    if (weight[i] > kHufMaxBits) return kCorrupt;
    if (weight[i]) total += 1u << (weight[i] - 1);
  }
  if (total == 0 || n >= 256) return kCorrupt;
  const int bits = highbit32(total) + 1;
  if (bits > kHufMaxBits) return kCorrupt;
  const uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) return kCorrupt;
  weight[n++] = uint8_t(highbit32(rest) + 1);
  // canonical codes: the smallest weights (longest codes) first, symbols ascending within a weight
  uint32_t rank_start[kHufMaxBits + 2] = {0};
  uint32_t rank_count[kHufMaxBits + 2] = {0};
  for (int i = 0; i < n; ++i) rank_count[weight[i]]++;
  uint32_t next = 0;
  for (int w = 1; w <= bits; ++w) {
    rank_start[w] = next;
    next += rank_count[w] << (w - 1);
  }
  if (next != (1u << bits)) return kCorrupt;
  for (int s = 0; s < n; ++s) {
    const int w = weight[s];
    if (!w) continue;
    const uint32_t span = 1u << (w - 1);
    const uint32_t at = rank_start[w];
    for (uint32_t k = 0; k < span; ++k) {
      h.symbol[at + k] = uint8_t(s);
      h.length[at + k] = uint8_t(bits + 1 - w);
    }
    rank_start[w] += span;
  }
  h.bits = bits;
  return int64_t(used);
}

// A Huffman stream being decoded into [p, end).
struct HufStream {
  BackBits br;
  uint8_t* p;
  uint8_t* end;
};

inline void huf_symbol(const HufTable& h, HufStream& s, unsigned bits) {
  const uint64_t i = s.br.look(bits);
  *s.p++ = h.symbol[i];
  s.br.consumed += h.length[i];
}

// The rest of one stream; it must end exactly with its last symbol.
bool huf_finish(const HufTable& h, HufStream& s) {
  const unsigned bits = unsigned(h.bits);
  while (s.end - s.p >= 4) {
    if (!s.br.reload()) return false;
    for (int k = 0; k < 4; ++k) huf_symbol(h, s, bits);
  }
  if (!s.br.reload()) return false;
  while (s.p < s.end) huf_symbol(h, s, bits);
  s.br.reload();
  return s.br.finished();
}

// Streams decoded in lockstep, four symbols of each per round, so their table lookups overlap; then each
// stream's tail on its own.
bool huf_decode_streams(const HufTable& h, HufStream* st, int n) {
  const unsigned bits = unsigned(h.bits);
  for (;;) {
    bool room = true;
    for (int s = 0; s < n; ++s) room = room && st[s].end - st[s].p >= 4 && st[s].br.ptr >= st[s].br.start + 8;
    if (!room) break;
    for (int s = 0; s < n; ++s) st[s].br.reload();
    for (int k = 0; k < 4; ++k)
      for (int s = 0; s < n; ++s) huf_symbol(h, st[s], bits);
  }
  for (int s = 0; s < n; ++s)
    if (!huf_finish(h, st[s])) return false;
  return true;
}

// ------------------------------------------------------------------ sequences

constexpr uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// RFC 8878 §3.1.1.3.2.1.1: each code's baseline and number of extra bits
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,    10,   11,   12,   13,    14,    15,   16,
                                  17, 18, 19, 20, 21, 22, 23,   24,   25,   26,   27,    28,    29,   30,
                                  31, 32, 33, 34, 35, 37, 39,   41,   43,   47,   51,    59,    67,   83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t literals[kBlockMax];
};

// One table of the sequences section, in `mode` → the bytes it took, or < 0.
int64_t read_seq_table(FseTable& t, bool& have, int mode, const uint8_t* src, size_t size, const int16_t* dflt,
                       int dflt_max, int dflt_log, int max_symbol, int max_log) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, dflt_max, dflt_log);
      have = true;
      return 0;
    case 1:
      if (size < 1 || src[0] > max_symbol) return kCorrupt;
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      int64_t d = fse_read_description(t, src, size, max_symbol, max_log);
      if (d < 0) return d;
      if (size_t(d) > size) return kCorrupt;
      have = true;
      return d;
    }
    default:
      return have ? int64_t(0) : int64_t(kCorrupt);   // repeat: the previous block's table
  }
}

// One compressed block → its output appended at `op`; the new end, or nullptr with `err` set.
uint8_t* decode_compressed_block(FrameState& fs, const uint8_t* src, size_t size, uint8_t* frame_start, uint8_t* op,
                                 uint8_t* oend, int64_t& err) {
  err = kCorrupt;
  if (size < 1) return nullptr;
  // literals section
  const uint8_t* ip = src;
  const uint8_t* const iend = src + size;
  const int ltype = ip[0] & 3, sfmt = (ip[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  if (ltype < 2) {
    if ((sfmt & 1) == 0) {
      hsize = 1;
      regen = ip[0] >> 3;
    } else if (sfmt == 1) {
      hsize = 2;
      if (size < 2) return nullptr;
      regen = (ip[0] >> 4) + (size_t(ip[1]) << 4);
    } else {
      hsize = 3;
      if (size < 3) return nullptr;
      regen = (ip[0] >> 4) + (size_t(ip[1]) << 4) + (size_t(ip[2]) << 12);
    }
  } else {
    hsize = sfmt < 2 ? 3 : size_t(sfmt) + 2;
    if (size < hsize) return nullptr;
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= uint64_t(ip[i]) << (8 * i);
    const int field = sfmt < 2 ? 10 : sfmt == 2 ? 14 : 18;
    regen = size_t((h >> 4) & ((1u << field) - 1));
    csize = size_t((h >> (4 + field)) & ((1u << field) - 1));
  }
  if (regen > kBlockMax) return nullptr;
  ip += hsize;
  const uint8_t* lit = fs.literals;
  if (ltype == 0) {
    if (size_t(iend - ip) < regen) return nullptr;
    lit = ip;   // raw literals are read in place
    ip += regen;
  } else if (ltype == 1) {
    if (ip >= iend) return nullptr;
    std::memset(fs.literals, ip[0], regen);
    ip += 1;
  } else {
    if (size_t(iend - ip) < csize) return nullptr;
    const uint8_t* lp = ip;
    size_t lsize = csize;
    if (ltype == 2) {
      int64_t t = huf_read_table(fs.huf, lp, lsize);
      if (t < 0) return nullptr;
      lp += t;
      lsize -= size_t(t);
    } else if (fs.huf.bits == 0) {
      return nullptr;   // treeless with no earlier table
    }
    if (sfmt == 0) {
      HufStream one{BackBits(), fs.literals, fs.literals + regen};
      if (!one.br.init(lp, lsize) || !huf_decode_streams(fs.huf, &one, 1)) return nullptr;
    } else {
      if (lsize < 6) return nullptr;
      const size_t s1 = lp[0] | (size_t(lp[1]) << 8), s2 = lp[2] | (size_t(lp[3]) << 8),
                   s3 = lp[4] | (size_t(lp[5]) << 8);
      if (s1 + s2 + s3 + 6 > lsize) return nullptr;
      const size_t s4 = lsize - 6 - s1 - s2 - s3;
      const size_t q = (regen + 3) / 4;
      if (3 * q > regen) return nullptr;
      const uint8_t* at = lp + 6;
      const size_t sizes[4] = {s1, s2, s3, s4};
      HufStream st[4];
      for (int k = 0; k < 4; ++k) {
        st[k].p = fs.literals + k * q;
        st[k].end = k < 3 ? st[k].p + q : fs.literals + regen;
        if (!st[k].br.init(at, sizes[k])) return nullptr;
        at += sizes[k];
      }
      if (!huf_decode_streams(fs.huf, st, 4)) return nullptr;
    }
    ip += csize;
  }
  const uint8_t* const lit_end = lit + regen;

  // sequences section
  if (ip >= iend) return nullptr;
  size_t nseq = ip[0];
  if (nseq == 0) {
    ip += 1;
  } else if (nseq < 128) {
    ip += 1;
  } else if (nseq < 255) {
    if (iend - ip < 2) return nullptr;
    nseq = ((nseq - 128) << 8) + ip[1];
    ip += 2;
  } else {
    if (iend - ip < 3) return nullptr;
    nseq = ip[1] + (size_t(ip[2]) << 8) + 0x7F00;
    ip += 3;
  }
  if (nseq == 0) {
    if (ip != iend) return nullptr;
    if (size_t(oend - op) < regen) {
      err = kDstTooSmall;
      return nullptr;
    }
    std::memcpy(op, lit, regen);
    return op + regen;
  }
  if (ip >= iend) return nullptr;
  const int modes = ip[0];
  if (modes & 3) return nullptr;
  ip += 1;
  int64_t d = read_seq_table(fs.ll, fs.have_ll, (modes >> 6) & 3, ip, size_t(iend - ip), kLLDefault, 35, 6, 35, 9);
  if (d < 0) return nullptr;
  ip += d;
  d = read_seq_table(fs.of, fs.have_of, (modes >> 4) & 3, ip, size_t(iend - ip), kOFDefault, 28, 5, 31, 8);
  if (d < 0) return nullptr;
  ip += d;
  d = read_seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, ip, size_t(iend - ip), kMLDefault, 52, 6, 52, 9);
  if (d < 0) return nullptr;
  ip += d;
  if (ip > iend) return nullptr;

  BackBits br;
  if (!br.init(ip, size_t(iend - ip))) return nullptr;
  uint16_t sll = fse_init(fs.ll, br), sof = fse_init(fs.of, br), sml = fse_init(fs.ml, br);
  br.reload();
  const uint8_t* lp = lit;
  for (size_t i = 0; i < nseq; ++i) {
    const unsigned ofc = fs.of.cell[sof].symbol, llc = fs.ll.cell[sll].symbol, mlc = fs.ml.cell[sml].symbol;
    if (ofc > 31 || llc > 35 || mlc > 52) return nullptr;
    uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
    br.reload();
    const uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
    const uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
    br.reload();
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      const unsigned idx = unsigned(ofv - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
        if (offset == 0) return nullptr;
        if (idx != 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = fse_update(fs.ll, sll, br);
      sml = fse_update(fs.ml, sml, br);
      sof = fse_update(fs.of, sof, br);
      br.reload();
    }
    if (br.overflowed()) return nullptr;
    // execute: ll literals, then ml bytes from `offset` back
    if (uint64_t(lit_end - lp) < ll) return nullptr;
    if (uint64_t(oend - op) < ll + ml) {
      err = kDstTooSmall;
      return nullptr;
    }
    std::memcpy(op, lp, ll);
    op += ll;
    lp += ll;
    if (offset > uint64_t(op - frame_start)) return nullptr;
    const uint8_t* m = op - offset;
    if (offset >= ml) {
      std::memcpy(op, m, ml);
      op += ml;
    } else {   // an overlapping match repeats its last `offset` bytes: copy whole periods, doubling
      uint64_t left = ml, dist = offset;
      while (left) {
        const uint64_t k = left < dist ? left : dist;
        std::memcpy(op, op - dist, k);
        op += k;
        left -= k;
        dist += k;
      }
    }
  }
  br.reload();
  if (!br.finished()) return nullptr;
  const size_t tail = size_t(lit_end - lp);
  if (size_t(oend - op) < tail) {
    err = kDstTooSmall;
    return nullptr;
  }
  std::memcpy(op, lp, tail);
  return op + tail;
}

struct FrameHeader {
  size_t header_size;
  int64_t content_size;   // kUnknown when absent
  bool checksum;
};

int64_t parse_frame_header(const uint8_t* src, size_t n, FrameHeader& fh) {
  if (n < 5) return kTruncated;
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) return kUnsupported;   // reserved bit
  fh.checksum = (fhd >> 2) & 1;
  size_t pos = 5;
  if (!single) {
    if (pos >= n) return kTruncated;
    const int exponent = src[pos] >> 3;
    if (exponent > 31 - 10) return kCorrupt;   // a window past 2 GiB
    ++pos;
  }
  const size_t dict_bytes = dict_flag == 0 ? 0 : dict_flag == 1 ? 1 : dict_flag == 2 ? 2 : 4;
  if (pos + dict_bytes > n) return kTruncated;
  uint32_t dict = 0;
  for (size_t i = 0; i < dict_bytes; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
  if (dict != 0) return kUnsupported;
  pos += dict_bytes;
  const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + fcs_bytes > n) return kTruncated;
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  pos += fcs_bytes;
  if (fcs > uint64_t(INT64_MAX)) return kCorrupt;
  fh.content_size = fcs_bytes ? int64_t(fcs) : kUnknown;
  fh.header_size = pos;
  return 0;
}

// The size of the frame's compressed data after its header (blocks and checksum), or < 0.
int64_t frame_span(const uint8_t* src, size_t n, const FrameHeader& fh) {
  size_t pos = fh.header_size;
  for (;;) {
    if (pos + 3 > n) return kTruncated;
    const uint32_t bh = src[pos] | (uint32_t(src[pos + 1]) << 8) | (uint32_t(src[pos + 2]) << 16);
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) return kCorrupt;
    pos += 3 + (type == 1 ? 1 : bsize);
    if (pos > n) return kTruncated;
    if (bh & 1) break;
  }
  if (fh.checksum) pos += 4;
  if (pos > n) return kTruncated;
  return int64_t(pos);
}

int64_t decode_frame(FrameState& fs, const uint8_t* src, size_t n, uint8_t* dst, uint8_t* dend, size_t& used) {
  FrameHeader fh;
  int64_t e = parse_frame_header(src, n, fh);
  if (e < 0) return e;
  fs.huf.bits = 0;
  fs.have_ll = fs.have_of = fs.have_ml = false;
  fs.rep[0] = 1;
  fs.rep[1] = 4;
  fs.rep[2] = 8;
  size_t pos = fh.header_size;
  uint8_t* op = dst;
  for (;;) {
    if (pos + 3 > n) return kTruncated;
    const uint32_t bh = src[pos] | (uint32_t(src[pos + 1]) << 8) | (uint32_t(src[pos + 2]) << 16);
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 0) {
      if (pos + bsize > n) return kTruncated;
      if (size_t(dend - op) < bsize) return kDstTooSmall;
      std::memcpy(op, src + pos, bsize);
      op += bsize;
      pos += bsize;
    } else if (type == 1) {
      if (pos + 1 > n) return kTruncated;
      if (size_t(dend - op) < bsize) return kDstTooSmall;
      std::memset(op, src[pos], bsize);
      op += bsize;
      pos += 1;
    } else if (type == 2) {
      if (bsize > kBlockMax) return kCorrupt;
      if (pos + bsize > n) return kTruncated;
      int64_t err;
      uint8_t* next = decode_compressed_block(fs, src + pos, bsize, dst, op, dend, err);
      if (next == nullptr) return err;
      op = next;
      pos += bsize;
    } else {
      return kCorrupt;
    }
    if (last) break;
  }
  const size_t produced = size_t(op - dst);
  if (fh.content_size >= 0 && uint64_t(fh.content_size) != produced) return kCorrupt;
  if (fh.checksum) {
    if (pos + 4 > n) return kTruncated;
    if (load32(src + pos) != uint32_t(xxh64(dst, produced))) return kChecksum;
    pos += 4;
  }
  used = pos;
  return int64_t(produced);
}

// Skippable frame at src → its whole size, or < 0.
int64_t skippable_size(const uint8_t* src, size_t n) {
  if (n < 8) return kTruncated;
  const uint64_t size = 8 + uint64_t(load32(src + 4));
  if (size > n) return kTruncated;
  return int64_t(size);
}

}  // namespace

extern "C" {

int64_t goalnet_zstd_content_size(const uint8_t* src, int64_t n) {
  if (src == nullptr || n <= 0) return kEmpty;
  size_t pos = 0, size = size_t(n);
  int64_t total = 0;
  bool unknown = false;
  while (pos < size) {
    if (size - pos < 4) return kTruncated;
    const uint32_t magic = load32(src + pos);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      int64_t s = skippable_size(src + pos, size - pos);
      if (s < 0) return s;
      pos += size_t(s);
      continue;
    }
    if (magic != kMagic) return kCorrupt;
    FrameHeader fh;
    int64_t e = parse_frame_header(src + pos, size - pos, fh);
    if (e < 0) return e;
    int64_t span = frame_span(src + pos, size - pos, fh);
    if (span < 0) return span;
    if (fh.content_size < 0) unknown = true;
    else total += fh.content_size;
    pos += size_t(span);
  }
  return unknown ? int64_t(kUnknown) : total;
}

int64_t goalnet_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (src == nullptr || n <= 0) return kEmpty;
  if (cap < 0 || (dst == nullptr && cap > 0)) return kDstTooSmall;
  FrameState* fs = new (std::nothrow) FrameState;
  if (fs == nullptr) return kCorrupt;
  size_t pos = 0, size = size_t(n);
  uint8_t* op = dst;
  uint8_t* const dend = dst + cap;
  int64_t result = 0;
  bool any = false;
  while (pos < size) {
    if (size - pos < 4) {
      result = kTruncated;
      break;
    }
    const uint32_t magic = load32(src + pos);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      int64_t s = skippable_size(src + pos, size - pos);
      if (s < 0) {
        result = s;
        break;
      }
      pos += size_t(s);
      any = true;
      continue;
    }
    if (magic != kMagic) {
      result = kCorrupt;
      break;
    }
    size_t used = 0;
    int64_t produced = decode_frame(*fs, src + pos, size - pos, op, dend, used);
    if (produced < 0) {
      result = produced;
      break;
    }
    op += produced;
    pos += used;
    any = true;
  }
  delete fs;
  if (result < 0) return result;
  if (!any) return kEmpty;
  return int64_t(op - dst);
}

}  // extern "C"
