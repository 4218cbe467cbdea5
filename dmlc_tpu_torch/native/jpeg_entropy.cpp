// Baseline JPEG entropy decoder: the host stage of the port's device decode.
//
// Parses each JPEG of a batch and Huffman-decodes it into quantized DCT
// coefficients, with no libjpeg and no other library. What is left of a
// decode (dequantization, the scaled IDCT, chroma upsampling, colour
// conversion and the resample to the target size) runs on the card, in
// csrc/jpeg_idct.cu, which reads what this file writes.
//
// Takes: SOI, APPn/COM (skipped; APP14 "Adobe" read for its colour
// transform), DQT (8- and 16-bit tables), SOF0/SOF1 at 8-bit precision,
// DHT, DRI with RSTn restart markers, SOS (interleaved or one component a
// scan), EOI, and byte stuffing. 1 or 3 components, sampling factors 1 or
// 2 in each direction, any width and height. Everything else gets a
// nonzero status of its own (kStatus* below) and never a crash.
//
// Scale: each image gets the M in 1..8 that the libjpeg path
// (native/image_pipeline.cpp decode_jpeg) would ask for: the smallest M with
// ceil(w*M/8) and ceil(h*M/8) both >= size, else 8. The scaled image is
// ceil(w*M/8) x ceil(h*M/8). A component at full resolution along an axis
// takes an M-point IDCT there. A component subsampled by 2 along it takes a
// 2M-point IDCT where 2M <= 8 (libjpeg's DCT-domain upsampling: its samples
// land on the scaled grid), else the 8-point one: its full-resolution
// samples, which the device upsamples to the full image (libjpeg's fancy
// filter) and resamples to the scaled grid (the triangle filter), the
// chroma PIL's full decode and resize give.
//
// Output: one caller-owned arena a batch (a pinned tensor on the Python
// side, reused from batch to batch), laid out by dmlc_jpeg_layout:
//   header   int32[16]   n, size, total_blocks, plane_bytes, max_comp_blocks,
//                        refused
//   basis    float[8][8][8]  the IDCT basis, written by the caller, untouched
//   images   int32[n][8]     status, width, height, ncomp, M, ws, hs, first comp
//   comps    int32[3n][16]   block_off, bw, bh, plane_off, pw, ph, cw, ch, fx,
//                            fy, nx, ny, srcw, srch, image, 0: the block grid,
//                            the plane (pw x ph bytes, cw x ch of it valid),
//                            the fancy upsampling factors to the source grid
//                            (srcw x srch: the scaled image, or the full
//                            image where it is resampled), the IDCT sizes
//   qtables  int32[3n][64]   each component's table, natural order
//   coef     int16[blocks][64]  every component's blocks, natural order,
//                               row-major over its MCU-padded block grid
// A refused image keeps its record (with its status) and no blocks.
//
// Threads: a persistent pool (the pattern of image_pipeline.cpp's
// DecodePool) claims images by an atomic cursor; the calling thread works
// too. C ABI only; Python binds with ctypes (dmlc_tpu_torch/native/jpeg.py).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Status : int32_t {
  kOk = 0,
  kReadFailed = 1,      // the file could not be read
  kNotJpeg = 2,         // no SOI: a PNG, or anything else
  kProgressive = 3,     // SOF2 / SOF6
  kArithmetic = 4,      // SOF9-SOF15 (not 12), DAC
  kUnsupportedSof = 5,  // lossless, hierarchical, reserved
  kPrecision = 6,       // not 8-bit samples
  kColorSpace = 7,      // 2 or 4+ components, RGB or CMYK/YCCK (Adobe transform)
  kSampling = 8,        // a sampling factor other than 1 or 2
  kCorrupt = 9,         // a malformed segment, table or entropy-coded data
  kTruncated = 10,      // the data ends before the image does
  kTooLarge = 11,       // more than kMaxPixels pixels
};

constexpr int kHdrInts = 16;
constexpr int kImgInts = 8;
constexpr int kCompInts = 16;
constexpr int kMaxComps = 3;
constexpr int64_t kMaxPixels = int64_t(1) << 26;

struct Layout {
  int64_t basis, images, comps, qt, coef;
};

Layout layout(int64_t n) {
  Layout l;
  l.basis = kHdrInts * 4;
  l.images = l.basis + 8 * 8 * 8 * 4;
  l.comps = l.images + n * kImgInts * 4;
  l.qt = l.comps + n * kMaxComps * kCompInts * 4;
  l.coef = (l.qt + n * kMaxComps * 64 * 4 + 127) / 128 * 128;
  return l;
}

// Zigzag index k -> natural (row-major) index.
const uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint16_t look[1 << kLookBits];  // (length << 8) | value; 0: longer code
  int32_t maxcode[18];            // largest code of each length, -1 if none
  int32_t valoff[17];             // value index minus first code, by length
  uint8_t vals[256];
};

// Builds the canonical code of a DHT table; false on an over-full table
// (a code that does not fit its length, or an all-ones code, as libjpeg
// refuses them). The fit is checked before each code is written, so an
// over-full table never writes past `look`.
bool build_huff(Huff& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  t.defined = false;
  std::memset(t.look, 0, sizeof(t.look));
  std::memcpy(t.vals, vals, nvals);
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    t.valoff[l] = k - code;
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      if (code >= (1 << l)) return false;
      if (l <= kLookBits) {
        const int shift = kLookBits - l;
        for (int pad = 0; pad < (1 << shift); ++pad)
          t.look[(code << shift) | pad] = (uint16_t)((l << 8) | vals[k]);
      }
    }
    t.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    if (code >= (1 << l) && counts[l - 1]) return false;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.defined = true;
  return true;
}

// Entropy-coded data as a bit stream: 0xFF00 reads as 0xFF, and a marker
// (or the end of the data) stops the stream, past which it reads zero
// bits that no decode may consume (`pad` counts them).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int pad = 0;
  bool at_marker = false;  // p points at the 0xFF of a marker

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      bool real = false;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          b = *p++;
          real = true;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {  // a stuffed 0xFF
            b = 0xFF;
            p = q + 1;
            real = true;
          } else {
            at_marker = true;
            p = q - 1;
          }
        }
      }
      if (!real) pad += 8;
      buf |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }

  bool need(int n) {
    if (bits < n) fill();
    return bits - pad >= n;
  }
  uint32_t peek(int n) const { return (uint32_t)(buf >> (64 - n)); }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  void reset() {
    buf = 0;
    bits = pad = 0;
  }
};

// One Huffman symbol, or -1 on a code no table holds or data that ran out.
inline int decode_symbol(BitReader& br, const Huff& t) {
  if (br.bits < 16) br.fill();
  const uint16_t e = t.look[br.peek(kLookBits)];
  if (e) {
    const int len = e >> 8;
    if (br.bits - br.pad < len) return -1;
    br.skip(len);
    return e & 0xFF;
  }
  for (int l = kLookBits + 1; l <= 16; ++l) {
    const int32_t code = (int32_t)br.peek(l);
    if (code <= t.maxcode[l]) {
      if (br.bits - br.pad < l) return -1;
      const int idx = t.valoff[l] + code;
      if (idx < 0 || idx > 255) return -1;
      br.skip(l);
      return t.vals[idx];
    }
  }
  return -1;
}

inline bool receive_extend(BitReader& br, int s, int& out) {
  if (s == 0) {
    out = 0;
    return true;
  }
  if (!br.need(s)) return false;
  const uint32_t v = br.peek(s);
  br.skip(s);
  out = v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
  return true;
}

// One 8x8 block (blk zeroed by the caller): DC difference then the AC
// run-lengths, written in natural order.
bool decode_block(BitReader& br, const Huff& dc, const Huff& ac, int& pred, int16_t* blk) {
  const int s = decode_symbol(br, dc);
  if (s < 0 || s > 15) return false;
  int diff;
  if (!receive_extend(br, s, diff)) return false;
  pred += diff;
  blk[0] = (int16_t)pred;
  for (int k = 1; k < 64; ++k) {
    const int rs = decode_symbol(br, ac);
    if (rs < 0) return false;
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      if (k > 63) return false;
      int v;
      if (!receive_extend(br, sz, v)) return false;
      blk[kNatural[k]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // MCU-padded block grid
  int cw = 0, ch = 0;          // valid samples of the component's plane
  int nx = 8, ny = 8;          // IDCT sizes
  int fx = 1, fy = 1;          // fancy upsampling to the source grid
  int srcw = 0, srch = 0;      // the source grid
  int64_t block_off = 0;       // in blocks, into the arena's coefficients
  int64_t plane_off = 0;       // in bytes, into the device's scratch planes
  bool scanned = false;
};

struct Image {
  const uint8_t* data = nullptr;
  int64_t len = 0;
  std::vector<uint8_t> owned;
  int32_t status = kOk;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, M = 8, ws = 0, hs = 0;
  int mcux = 0, mcuy = 0;
  Comp comp[kMaxComps];
  bool adobe = false, jfif = false;
  int adobe_transform = -1;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

inline int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// The reference's rule (native/image_pipeline.cpp decode_jpeg).
int pick_scale(int w, int h, int size) {
  if (size > 0) {
    for (int m = 1; m <= 8; ++m) {
      if ((int)(((unsigned)w * (unsigned)m + 7) / 8) >= size &&
          (int)(((unsigned)h * (unsigned)m + 7) / 8) >= size)
        return m;
    }
  }
  return 8;
}

// Frame header -> geometry, or a status.
int parse_sof(Image& im, const uint8_t* s, int n, int size) {
  if (n < 6) return kCorrupt;
  if (s[0] != 8) return kPrecision;
  im.height = be16(s + 1);
  im.width = be16(s + 3);
  im.ncomp = s[5];
  if (im.height == 0 || im.width == 0) return kCorrupt;  // DNL: not taken
  if (im.ncomp != 1 && im.ncomp != 3) return kColorSpace;
  if (n < 6 + 3 * im.ncomp) return kCorrupt;
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h == 0 || k.v == 0 || k.tq > 3) return kCorrupt;
    if (k.h > 2 || k.v > 2) return kSampling;
    for (int d = 0; d < c; ++d)
      if (im.comp[d].id == k.id) return kCorrupt;
  }
  if (im.ncomp == 3) {
    // libjpeg's colour-space guess: JFIF or Adobe transform 1 means YCbCr,
    // Adobe transform 0 or component ids 'R','G','B' mean RGB.
    const bool rgb_ids = im.comp[0].id == 'R' && im.comp[1].id == 'G' && im.comp[2].id == 'B';
    if (!im.jfif && im.adobe && im.adobe_transform == 0) return kColorSpace;
    if (!im.jfif && !im.adobe && rgb_ids) return kColorSpace;
  } else {
    im.comp[0].h = im.comp[0].v = 1;  // one component: one block an MCU
  }
  if ((int64_t)im.width * im.height > kMaxPixels) return kTooLarge;
  im.hmax = im.vmax = 1;
  for (int c = 0; c < im.ncomp; ++c) {
    im.hmax = std::max(im.hmax, im.comp[c].h);
    im.vmax = std::max(im.vmax, im.comp[c].v);
  }
  im.mcux = ceil_div(im.width, 8 * im.hmax);
  im.mcuy = ceil_div(im.height, 8 * im.vmax);
  im.M = pick_scale(im.width, im.height, size);
  im.ws = ceil_div((int64_t)im.width * im.M, 8);
  im.hs = ceil_div((int64_t)im.height * im.M, 8);
  for (int c = 0; c < im.ncomp; ++c) {
    Comp& k = im.comp[c];
    k.bw = im.mcux * k.h;
    k.bh = im.mcuy * k.v;
    const bool sub_x = im.hmax / k.h == 2, sub_y = im.vmax / k.v == 2;
    const bool full_x = sub_x && 2 * im.M > 8, full_y = sub_y && 2 * im.M > 8;
    k.nx = sub_x ? (full_x ? 8 : 2 * im.M) : im.M;
    k.ny = sub_y ? (full_y ? 8 : 2 * im.M) : im.M;
    k.fx = full_x ? 2 : 1;
    k.fy = full_y ? 2 : 1;
    k.srcw = full_x ? im.width : im.ws;
    k.srch = full_y ? im.height : im.hs;
    k.cw = ceil_div((int64_t)im.width * k.h * k.nx, (int64_t)im.hmax * 8);
    k.ch = ceil_div((int64_t)im.height * k.v * k.ny, (int64_t)im.vmax * 8);
  }
  return kOk;
}

// Marker-level reader over the whole file.
struct Reader {
  const uint8_t* d;
  int64_t n;
  int64_t pos;

  // The next marker's code, skipping bytes before it and fill bytes; -1 at
  // the end of the data.
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return -1;
    return d[pos++];
  }
  // A segment's payload (after its length field); false when it overruns.
  bool segment(const uint8_t*& seg, int& seglen) {
    if (pos + 2 > n) return false;
    const int len = be16(d + pos);
    if (len < 2 || pos + len > n) return false;
    seg = d + pos + 2;
    seglen = len - 2;
    pos += len;
    return true;
  }
};

struct Tables {
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
};

int parse_dqt(Tables& t, const uint8_t* s, int n) {
  int i = 0;
  while (i < n) {
    const int pq = s[i] >> 4, tq = s[i] & 15;
    ++i;
    if (tq > 3 || pq > 1) return kCorrupt;
    const int bytes = pq ? 128 : 64;
    if (i + bytes > n) return kCorrupt;
    for (int k = 0; k < 64; ++k)
      t.qt[tq][kNatural[k]] = pq ? be16(s + i + 2 * k) : s[i + k];
    t.qt_defined[tq] = true;
    i += bytes;
  }
  return kOk;
}

int parse_dht(Tables& t, const uint8_t* s, int n) {
  int i = 0;
  while (i < n) {
    if (i + 17 > n) return kCorrupt;
    const int tc = s[i] >> 4, th = s[i] & 15;
    if (tc > 1 || th > 3) return kCorrupt;
    const uint8_t* counts = s + i + 1;
    int total = 0;
    for (int l = 0; l < 16; ++l) total += counts[l];
    if (total > 256 || i + 17 + total > n) return kCorrupt;
    Huff& h = tc ? t.ac[th] : t.dc[th];
    if (!build_huff(h, counts, s + i + 17, total)) return kCorrupt;
    i += 17 + total;
  }
  return kOk;
}

// Finds the next marker at or after br.p (the end of a scan, or a restart
// marker); br stops at it.
void seek_marker(BitReader& br) {
  if (br.at_marker) return;
  const uint8_t* p = br.p;
  while (p < br.end) {
    if (*p == 0xFF) {
      const uint8_t* q = p + 1;
      while (q < br.end && *q == 0xFF) ++q;
      if (q < br.end && *q != 0x00) {
        br.p = q - 1;
        br.at_marker = true;
        return;
      }
      p = q + 1;
    } else {
      ++p;
    }
  }
  br.p = br.end;
}

// One scan, from its SOS payload to the marker after its data.
int decode_scan(Image& im, Tables& t, Reader& r, const uint8_t* s, int n, int16_t* coef,
                int32_t* qt_out) {
  if (n < 1) return kCorrupt;
  const int ns = s[0];
  if (ns < 1 || ns > im.ncomp || n < 1 + 2 * ns + 3) return kCorrupt;
  int sc[kMaxComps], td[kMaxComps], ta[kMaxComps];
  for (int i = 0; i < ns; ++i) {
    const int id = s[1 + 2 * i];
    sc[i] = -1;
    for (int c = 0; c < im.ncomp; ++c)
      if (im.comp[c].id == id) sc[i] = c;
    if (sc[i] < 0) return kCorrupt;
    for (int j = 0; j < i; ++j)
      if (sc[j] == sc[i]) return kCorrupt;
    td[i] = s[2 + 2 * i] >> 4;
    ta[i] = s[2 + 2 * i] & 15;
    if (td[i] > 3 || ta[i] > 3 || !t.dc[td[i]].defined || !t.ac[ta[i]].defined) return kCorrupt;
    Comp& k = im.comp[sc[i]];
    if (k.scanned || !t.qt_defined[k.tq]) return kCorrupt;
    // The table in force at the component's first (here: only) scan.
    std::memcpy(qt_out + 64 * sc[i], t.qt[k.tq], sizeof(t.qt[0]));
    k.scanned = true;
  }
  const uint8_t* tail = s + 1 + 2 * ns;
  if (tail[0] != 0 || tail[1] != 63 || tail[2] != 0) return kCorrupt;  // not sequential

  BitReader br;
  br.p = r.d + r.pos;
  br.end = r.d + r.n;
  int pred[kMaxComps] = {0, 0, 0};
  int64_t mcus, per_row;
  int bw1 = 0, bh1 = 0;
  if (ns == 1) {
    // One component a scan: its blocks in raster order, one an MCU, over
    // the blocks that hold its samples (not the MCU padding).
    const Comp& k = im.comp[sc[0]];
    const int64_t comp_w = ceil_div((int64_t)im.width * k.h, im.hmax);
    const int64_t comp_h = ceil_div((int64_t)im.height * k.v, im.vmax);
    bw1 = ceil_div(comp_w, 8);
    bh1 = ceil_div(comp_h, 8);
    per_row = bw1;
    mcus = (int64_t)bw1 * bh1;
  } else {
    per_row = im.mcux;
    mcus = (int64_t)im.mcux * im.mcuy;
  }
  int next_rst = 0;
  for (int64_t m = 0; m < mcus; ++m) {
    if (t.restart_interval && m > 0 && m % t.restart_interval == 0) {
      br.reset();
      seek_marker(br);
      if (!br.at_marker || br.p + 1 >= br.end) return kTruncated;
      if (br.p[1] != 0xD0 + next_rst) return kCorrupt;
      br.p += 2;
      br.at_marker = false;
      next_rst = (next_rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = 0;
    }
    const int64_t my = m / per_row, mx = m % per_row;
    for (int i = 0; i < ns; ++i) {
      const Comp& k = im.comp[sc[i]];
      const int hh = ns == 1 ? 1 : k.h, vv = ns == 1 ? 1 : k.v;
      for (int v = 0; v < vv; ++v) {
        for (int h = 0; h < hh; ++h) {
          const int64_t row = my * vv + v, col = mx * hh + h;
          int16_t* blk = coef + (k.block_off + row * k.bw + col) * 64;
          if (!decode_block(br, t.dc[td[i]], t.ac[ta[i]], pred[sc[i]], blk))
            return br.bits - br.pad <= 0 || br.p >= br.end || br.at_marker ? kTruncated
                                                                           : kCorrupt;
        }
      }
    }
  }
  seek_marker(br);
  r.pos = br.p - r.d;
  return kOk;
}

// Reads the file (when the image came as a path) and parses up to the frame
// header: the geometry the arena needs.
void parse_header(Image& im, const char* path, int size) {
  if (path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) {
      im.status = kReadFailed;
      return;
    }
    std::fseek(f, 0, SEEK_END);
    const long len = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (len < 0) {
      std::fclose(f);
      im.status = kReadFailed;
      return;
    }
    im.owned.resize((size_t)len);
    const size_t got = len ? std::fread(im.owned.data(), 1, (size_t)len, f) : 0;
    std::fclose(f);
    if (got != (size_t)len) {
      im.status = kReadFailed;
      return;
    }
    im.data = im.owned.data();
    im.len = len;
  }
  if (im.len < 4 || im.data[0] != 0xFF || im.data[1] != 0xD8) {
    im.status = kNotJpeg;
    return;
  }
  Reader r{im.data, im.len, 2};
  for (;;) {
    const int m = r.next_marker();
    const uint8_t* s;
    int n;
    switch (m) {
      case -1:
      case 0xD9:
        im.status = kTruncated;
        return;
      case 0xD8:
      case 0xDA:
        im.status = kCorrupt;
        return;
      case 0x01:
      case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        continue;
      case 0xC0:
      case 0xC1:
        if (!r.segment(s, n)) {
          im.status = kTruncated;
          return;
        }
        im.status = parse_sof(im, s, n, size);
        return;
      case 0xC2:
      case 0xC6:
        im.status = kProgressive;
        return;
      case 0xC3: case 0xC5: case 0xC7: case 0xC8:
        im.status = kUnsupportedSof;
        return;
      case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE: case 0xCF:
        im.status = kArithmetic;
        return;
      default:
        if (!r.segment(s, n)) {
          im.status = kTruncated;
          return;
        }
        if (m == 0xE0 && n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) im.jfif = true;
        if (m == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
          im.adobe = true;
          im.adobe_transform = s[11];
        }
    }
  }
}

// The whole file again, now with its tables and scans, into the arena.
int decode_image(Image& im, int16_t* coef, int32_t* qt_out) {
  Tables t;
  Reader r{im.data, im.len, 2};
  bool frame = false;
  for (;;) {
    const int m = r.next_marker();
    const uint8_t* s;
    int n;
    int st = kOk;
    switch (m) {
      case -1:
      case 0xD9:
        if (!frame) return kTruncated;
        for (int c = 0; c < im.ncomp; ++c)
          if (!im.comp[c].scanned) return kTruncated;
        return kOk;
      case 0xD8:
        return kCorrupt;
      case 0x01:
      case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        continue;
      default:
        if (!r.segment(s, n)) return kTruncated;
        if (m == 0xC0 || m == 0xC1) {
          if (frame) return kCorrupt;
          frame = true;  // parsed by parse_header
        } else if (m == 0xC4) {
          st = parse_dht(t, s, n);
        } else if (m == 0xDB) {
          st = parse_dqt(t, s, n);
        } else if (m == 0xDD) {
          if (n < 2) return kCorrupt;
          t.restart_interval = be16(s);
        } else if (m == 0xDA) {
          if (!frame) return kCorrupt;
          st = decode_scan(im, t, r, s, n, coef, qt_out);
        } else if (m == 0xDC || (m >= 0xC2 && m <= 0xCF)) {
          return kCorrupt;  // DNL, or a second frame of another kind
        }
        if (st != kOk) return st;
    }
  }
}

// ---- persistent pool -------------------------------------------------------
//
// A call publishes one Job of n items; pool workers and the submitting
// thread claim item indices by fetch_add. The submitter returns once every
// item is done and no worker is still inside the job.

struct Job {
  const std::function<void(int)>* fn = nullptr;
  int n = 0;
  std::atomic<int> next{0};
  int done = 0;    // guarded by Pool::mu_
  int active = 0;  // guarded by Pool::mu_
  std::condition_variable done_cv;
};

class Pool {
 public:
  static Pool& instance() {
    static Pool* pool = new Pool();  // leaked: see image_pipeline.cpp DecodePool
    return *pool;
  }

  void run(int n, int n_threads, const std::function<void(int)>& fn) {
    if (n <= 0) return;
    ensure(n_threads);
    Job job;
    job.fn = &fn;
    job.n = n;
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push_back(&job);
    }
    cv_.notify_all();
    const int finished = work(&job);
    std::unique_lock<std::mutex> lk(mu_);
    job.done += finished;
    job.done_cv.wait(lk, [&] { return job.done >= job.n && job.active == 0; });
    for (auto it = jobs_.begin(); it != jobs_.end(); ++it) {
      if (*it == &job) {
        jobs_.erase(it);
        break;
      }
    }
  }

  void ensure(int n_threads) {
    size_t want = n_threads > 0 ? (size_t)n_threads
                                : (size_t)std::max(1u, std::thread::hardware_concurrency());
    want = std::min(want, (size_t)64);
    std::lock_guard<std::mutex> lk(mu_);
    while (workers_.size() < want) workers_.emplace_back([this] { loop(); });
  }

  int size() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int)workers_.size();
  }

 private:
  void loop() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return !jobs_.empty(); });
      Job* job = jobs_.front();
      if (job->next.load(std::memory_order_relaxed) >= job->n) {
        jobs_.pop_front();
        continue;
      }
      ++job->active;
      lk.unlock();
      const int finished = work(job);
      lk.lock();
      --job->active;
      job->done += finished;
      if (job->done >= job->n && job->active == 0) job->done_cv.notify_all();
    }
  }

  static int work(Job* job) {
    int finished = 0;
    for (;;) {
      const int i = job->next.fetch_add(1);
      if (i >= job->n) return finished;
      (*job->fn)(i);
      ++finished;
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Job*> jobs_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

// Byte offsets of the arena's regions for a batch of n: basis, images,
// comps, qtables, coef.
void dmlc_jpeg_layout(int n, int64_t* out) {
  const Layout l = layout(n);
  out[0] = l.basis;
  out[1] = l.images;
  out[2] = l.comps;
  out[3] = l.qt;
  out[4] = l.coef;
}

// Entropy-decode n JPEGs into `arena` (capacity bytes). Each image comes
// from paths[i] when bufs is null, else from bufs[i] (lens[i] bytes).
// Returns the number of refused images (status != 0); -1 when the arena is
// smaller than the batch needs (*needed says how large; nothing written
// but *needed); -2 when the batch's blocks or planes overflow int32.
int dmlc_jpeg_decode_batch(const char** paths, const uint8_t** bufs, const int64_t* lens, int n,
                           int size, uint8_t* arena, int64_t capacity, int64_t* needed,
                           int n_threads) {
  if (n < 0) return -2;
  std::vector<Image> ims((size_t)n);
  if (bufs) {
    for (int i = 0; i < n; ++i) {
      ims[i].data = bufs[i];
      ims[i].len = bufs[i] ? lens[i] : 0;
    }
  }
  Pool& pool = Pool::instance();
  std::function<void(int)> header = [&](int i) {
    parse_header(ims[i], bufs ? nullptr : paths[i], size);
  };
  pool.run(n, n_threads, header);

  int64_t blocks = 0, planes = 0, max_comp = 0;
  for (auto& im : ims) {
    if (im.status != kOk) continue;
    for (int c = 0; c < im.ncomp; ++c) {
      Comp& k = im.comp[c];
      k.block_off = blocks;
      k.plane_off = planes;
      blocks += (int64_t)k.bw * k.bh;
      planes += (int64_t)k.bw * k.bh * k.nx * k.ny;
      max_comp = std::max(max_comp, (int64_t)k.bw * k.bh);
    }
  }
  if (blocks * 64 > INT32_MAX || planes > INT32_MAX) return -2;
  const Layout l = layout(n);
  *needed = l.coef + blocks * 64 * 2;
  if (*needed > capacity) return -1;

  int32_t* hdr = reinterpret_cast<int32_t*>(arena);
  int32_t* img_rec = reinterpret_cast<int32_t*>(arena + l.images);
  int32_t* comp_rec = reinterpret_cast<int32_t*>(arena + l.comps);
  int32_t* qt = reinterpret_cast<int32_t*>(arena + l.qt);
  int16_t* coef = reinterpret_cast<int16_t*>(arena + l.coef);
  std::memset(arena + l.images, 0, (size_t)(l.coef - l.images));

  std::function<void(int)> body = [&](int i) {
    Image& im = ims[i];
    if (im.status != kOk) return;
    int64_t first = im.comp[0].block_off, count = 0;
    for (int c = 0; c < im.ncomp; ++c) count += (int64_t)im.comp[c].bw * im.comp[c].bh;
    std::memset(coef + first * 64, 0, (size_t)count * 64 * 2);
    im.status = decode_image(im, coef, qt + (int64_t)i * kMaxComps * 64);
  };
  pool.run(n, n_threads, body);

  int refused = 0;
  for (int i = 0; i < n; ++i) {
    const Image& im = ims[i];
    int32_t* rec = img_rec + (int64_t)i * kImgInts;
    rec[0] = im.status;
    rec[7] = i * kMaxComps;
    if (im.status != kOk) {
      ++refused;
      continue;
    }
    rec[1] = im.width;
    rec[2] = im.height;
    rec[3] = im.ncomp;
    rec[4] = im.M;
    rec[5] = im.ws;
    rec[6] = im.hs;
    for (int c = 0; c < im.ncomp; ++c) {
      const Comp& k = im.comp[c];
      int32_t* cr = comp_rec + ((int64_t)i * kMaxComps + c) * kCompInts;
      cr[0] = (int32_t)k.block_off;
      cr[1] = k.bw;
      cr[2] = k.bh;
      cr[3] = (int32_t)k.plane_off;
      cr[4] = k.bw * k.nx;
      cr[5] = k.bh * k.ny;
      cr[6] = k.cw;
      cr[7] = k.ch;
      cr[8] = k.fx;
      cr[9] = k.fy;
      cr[10] = k.nx;
      cr[11] = k.ny;
      cr[12] = k.srcw;
      cr[13] = k.srch;
      cr[14] = i;
      cr[15] = 0;
    }
  }
  hdr[0] = n;
  hdr[1] = size;
  hdr[2] = (int32_t)blocks;
  hdr[3] = (int32_t)planes;
  hdr[4] = (int32_t)max_comp;
  hdr[5] = refused;
  for (int k = 6; k < kHdrInts; ++k) hdr[k] = 0;
  return refused;
}

int dmlc_jpeg_pool_size() { return Pool::instance().size(); }

int dmlc_jpeg_abi_version() { return 1; }

}  // extern "C"
