// jpeg_plan: the plan the jpeg_idct kernel (csrc/jpeg_idct.cu) reads for a
// batch, built on the host by ops/jpeg.py (batch_plan) from the entropy
// decoder's image and component records.
//
// For each image geometry of the batch (components, scaled size, each
// component's source grid and fancy factors) the colour pass's tiles and
// its resample tables; for the batch the IDCT's runs. A tile is a range of
// output rows by a range of output columns, so its staged extents are a
// row range's by a column range's, worked out once an axis (Axis). Tiles
// start at kTileRows full-width rows and halve their rows or columns,
// whichever stages less, until their shared-memory stages fit kSmemBudget;
// a geometry whose 1x1 tile would pass kSmemMax is refused. A geometry's
// record is kept for later batches (kKeptGeometries at most).
//
// The tables are make_taps' triangle weights (native/image_pipeline.cpp),
// computed as ops/jpeg.py resample_taps computes them: each unnormalised
// weight in double, summed one after the other and divided by the sum,
// then rounded to float32; zero taps dropped, which is exact because a
// zero tap adds +0 to a sum of non-negative terms. Built with
// -ffp-contract=off (native/jpeg.py CXXFLAGS), so no multiply and add are
// fused and every double operation rounds as Python's do.
//
// The record layouts (kPlanHdr, kGeomInts, kTileInts, the Geom and Tile
// fields) are csrc/jpeg_idct.cu's; tests/test_torch_jpeg.py pins both
// files to ops/jpeg.py's constants.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxComps = 3;
constexpr int kPlanHdr = 4;
constexpr int kGeomInts = 28;
constexpr int kTileInts = 32;
constexpr int kRunBlocks = 16;
constexpr int kTileRows = 16;
constexpr int kSmemBudget = 65536;
constexpr int kSmemMax = 232448;
enum Geom { kNTiles = 0, kTiles = 1, kResize = 2, kFY = 3, kFX = 4, kCY = 5, kCX = 8, kS = 11,
            kF = 14, kH = 17, kQ = 20, kP = 23, kT = 24, kO = 25, kSmem = 26, kTwin = 27 };
enum Tile { kOut = 0, kScaled = 4, kSrc = 8, kBox = 20 };
static_assert(kTwin + 1 == kGeomInts, "geometry record");
static_assert(kBox + 4 * kMaxComps == kTileInts, "tile record");

// Return codes past the lengths.
constexpr int64_t kBadArgs = -1, kTooLarge = -2, kOverflow = -3, kNoWeight = -4;

// A resample's taps without its zero weights: output o reads source
// samples first[o] .. first[o] + count[o] - 1 with weights w[o * k ...].
struct Taps {
  int k = 0;
  std::vector<int32_t> first, count;
  std::vector<float> w;
  bool monotone = false;  // first and first + count never fall
};

bool trimmed_taps(int in, int out, Taps* t) {
  const double scale = (double)in / (double)out;
  const double support = std::max(1.0, scale);
  const double div = support > 1.0 ? scale : 1.0;
  std::vector<int> lo(out), hi(out);
  int span = 1;
  for (int o = 0; o < out; ++o) {
    const double center = (o + 0.5) * scale;
    lo[o] = std::max(0, (int)std::floor(center - support));
    hi[o] = std::min(in, (int)std::ceil(center + support));
    span = std::max(span, hi[o] - lo[o]);
  }
  std::vector<double> w(span);
  std::vector<float> rows((size_t)out * span, 0.f);
  t->first.assign(out, 0);
  t->count.assign(out, 0);
  t->k = 0;
  for (int o = 0; o < out; ++o) {
    const double center = (o + 0.5) * scale;
    const int m = hi[o] - lo[o];
    double total = 0.0;
    for (int i = 0; i < m; ++i) {
      const double x = lo[o] + i + 0.5 - center;
      const double d = std::fabs(div == 1.0 ? x : x / div);  // x / 1.0 is x
      w[i] = d < 1.0 ? 1.0 - d : 0.0;
      total += w[i];
    }
    if (total <= 0.0) {  // make_taps' nearest sample
      const int near = std::min(std::max((int)center, lo[o]), hi[o] - 1);
      for (int i = 0; i < m; ++i) w[i] = lo[o] + i == near ? 1.0 : 0.0;
      total = 1.0;
    }
    float* row = &rows[(size_t)o * span];
    int a = -1, b = -1;
    for (int i = 0; i < m; ++i) {
      row[i] = (float)(w[i] / total);
      if (row[i] != 0.f) {
        if (a < 0) a = i;
        b = i;
      }
    }
    if (a < 0) return false;
    t->first[o] = lo[o] + a;
    t->count[o] = b - a + 1;
    t->k = std::max(t->k, b - a + 1);
    std::memmove(row, row + a, sizeof(float) * (b - a + 1));
    std::fill(row + (b - a + 1), row + span, 0.f);
  }
  t->monotone = true;
  for (int o = 1; o < out; ++o)
    t->monotone &= t->first[o] >= t->first[o - 1] &&
                   t->first[o] + t->count[o] >= t->first[o - 1] + t->count[o - 1];
  t->w.assign((size_t)out * t->k, 0.f);
  for (int o = 0; o < out; ++o)
    std::memcpy(&t->w[(size_t)o * t->k], &rows[(size_t)o * span], sizeof(float) * t->k);
  return true;
}

// The tables of one batch, by (in, out): a table two axes or components
// share is made once and placed once in a geometry's record.
struct TapCache {
  std::map<std::pair<int, int>, Taps> made;
  bool failed = false;
  const Taps* get(int in, int out) {
    auto it = made.find({in, out});
    if (it == made.end()) {
      it = made.emplace(std::make_pair(in, out), Taps()).first;
      if (!trimmed_taps(in, out, &it->second)) failed = true;
    }
    return &it->second;
  }
};

// The source range [a, b) that outputs [lo, hi) of `t` read.
void extent(const Taps& t, int64_t lo, int64_t hi, int64_t* a, int64_t* b) {
  if (t.monotone) {
    *a = t.first[lo];
    *b = (int64_t)t.first[hi - 1] + t.count[hi - 1];
    return;
  }
  int64_t first = INT64_MAX, end = INT64_MIN;
  for (int64_t o = lo; o < hi; ++o) {
    first = std::min<int64_t>(first, t.first[o]);
    end = std::max<int64_t>(end, (int64_t)t.first[o] + t.count[o]);
  }
  *a = first;
  *b = end;
}

// The plane range that fancy samples [lo, hi) of a source axis of `src`
// samples read: along a factor-2 axis sample j blends plane samples j / 2
// and its neighbour toward j, within the plane's ceil(src / 2) samples.
void box(int64_t lo, int64_t hi, int factor, int src, int64_t* a, int64_t* b) {
  if (factor == 1) {
    *a = lo;
    *b = hi;
    return;
  }
  *a = std::max<int64_t>((lo >> 1) - 1, 0);
  *b = std::min<int64_t>(((hi - 1) >> 1) + 2, (src + 1) / 2);
}

int64_t a16(int64_t n) { return (n + 15) / 16 * 16; }

// One component along one axis: its source samples and fancy factor, and
// its table to the scaled grid (null: not resampled).
struct AxisComp {
  int src, factor;
  const Taps* taps;
};

// One output range [o0, o1) of an axis: its scaled extent [S0, S1) and,
// for each component, its source extent [s0, s1) and plane range [b0, b1).
using Range = std::array<int64_t, 4 + 4 * kMaxComps>;
// The largest of each width over an axis's ranges: output, scaled, then
// each component's source extent and plane range.
using Widest = std::array<int64_t, 2 + 2 * kMaxComps>;

Range make_range(int o0, int o1, const Taps* resize, const AxisComp* comps, int ncomp) {
  Range r{};
  r[0] = o0;
  r[1] = o1;
  if (resize) {
    extent(*resize, r[0], r[1], &r[2], &r[3]);
  } else {
    r[2] = r[0];
    r[3] = r[1];
  }
  for (int c = 0; c < ncomp; ++c) {
    int64_t* s = &r[4 + 4 * c];
    if (comps[c].taps) {
      extent(*comps[c].taps, r[2], r[3], &s[0], &s[1]);
    } else {
      s[0] = r[2];
      s[1] = r[3];
    }
    box(s[0], s[1], comps[c].factor, comps[c].src, &s[2], &s[3]);
  }
  return r;
}

// One axis of a geometry's tiles: its output cut into ranges of `length`.
struct Axis {
  int size;
  const Taps* resize;
  const AxisComp* comps;
  int ncomp;
  std::map<int, Widest> seen;  // by length

  const Widest& widest(int length) {
    auto it = seen.find(length);
    if (it != seen.end()) return it->second;
    Widest w{};
    for (int o0 = 0; o0 < size; o0 += length) {
      const Range r = make_range(o0, std::min(o0 + length, size), resize, comps, ncomp);
      for (int i = 0; i < 2 + 2 * ncomp; ++i) w[i] = std::max(w[i], r[2 * i + 1] - r[2 * i]);
    }
    return seen.emplace(length, w).first->second;
  }

  std::vector<Range> ranges(int length) const {
    std::vector<Range> out;
    for (int o0 = 0; o0 < size; o0 += length)
      out.push_back(make_range(o0, std::min(o0 + length, size), resize, comps, ncomp));
    return out;
  }
};

// A component's source grid (srcw, srch) and fancy factors (fx, fy).
struct Comp {
  int srcw, srch, fx, fy;
  bool operator==(const Comp& o) const {
    return srcw == o.srcw && srch == o.srch && fx == o.fx && fy == o.fy;
  }
};

using Layout = std::array<int64_t, 16>;  // S0-2, F0-2, H0-2, Q0-2, P, T, O, total

// Shared-memory offsets of the tiles' stages from the two axes' largest
// widths. A component on the scaled grid and not upsampled copies its box
// straight into S. What lives together: S and Q while the boxes are
// copied; S, Q and F while the fancy samples are made; S, F and H in the
// horizontal pass; S, H and P in the vertical pass with the colour
// conversion; P, T and O in the resample to size x size. So Q shares H's
// region, P F's, and T and O S's and H's.
Layout layout(const Widest& y, const Widest& x, const Comp* comps, int ncomp, int ws, int hs,
              bool resize) {
  const int64_t* ny = y.data();
  const int64_t* nx = x.data();
  const int64_t scaled = ny[1] * nx[1], out_px = ny[0] * nx[0];
  Layout lay;
  lay.fill(-1);
  int64_t* s_at = &lay[0];
  int64_t* f_at = &lay[3];
  int64_t* h_at = &lay[6];
  int64_t* q_at = &lay[9];
  std::vector<std::pair<int, int64_t>> f_bytes, q_bytes;
  int64_t at = 0;
  for (int c = 0; c < ncomp; ++c) {
    const bool resampled = comps[c].srcw != ws || comps[c].srch != hs;
    if (!resampled) {
      s_at[c] = at;
      at += a16(scaled);
    }
    if (comps[c].fx == 2 || comps[c].fy == 2) q_bytes.push_back({c, ny[3 + 2 * c] * nx[3 + 2 * c]});
    if (resampled) f_bytes.push_back({c, ny[2 + 2 * c] * nx[2 + 2 * c]});
  }
  const int64_t h_start = at;
  for (auto& [c, bytes] : f_bytes) {
    h_at[c] = at;
    at += a16(4 * ny[2 + 2 * c] * nx[1]);
  }
  int64_t q_end = h_start;
  for (auto& [c, bytes] : q_bytes) {
    q_at[c] = q_end;
    q_end += a16(bytes);
  }
  at = std::max(at, q_end);
  int64_t o = 0;
  if (resize) {
    o = a16(12 * ny[1] * nx[0]);
    at = std::max(at, o + a16(3 * out_px + 16));
  }
  const int64_t p = at;
  for (auto& [c, bytes] : f_bytes) {
    f_at[c] = at;
    at += a16(bytes);
  }
  lay[12] = p;
  lay[13] = 0;
  lay[14] = o;
  // 16: the staged output sits at its first byte's alignment
  lay[15] = std::max(at, p + a16(3 * scaled + 16));
  return lay;
}

// A plan as it is built: int32 values, any past int32 noted.
struct Out {
  std::vector<int32_t> v;
  bool overflow = false;
  void put(int64_t x) {
    overflow |= x < INT32_MIN || x > INT32_MAX;
    v.push_back((int32_t)x);
  }
};

// The record of one geometry (its head, tiles and tables) appended to
// `out`; kTooLarge with the 1x1 tile's bytes in *bytes past kSmemMax.
int64_t geometry_plan(int ncomp, int ws, int hs, const Comp* comps, int size, TapCache* cache,
                      Out* out, int64_t* bytes) {
  const bool resize = ws != size || hs != size;
  AxisComp along_y[kMaxComps], along_x[kMaxComps];
  bool resampled[kMaxComps];
  for (int c = 0; c < ncomp; ++c) {
    resampled[c] = comps[c].srcw != ws || comps[c].srch != hs;
    along_y[c] = {comps[c].srch, comps[c].fy,
                  resampled[c] ? cache->get(comps[c].srch, hs) : nullptr};
    along_x[c] = {comps[c].srcw, comps[c].fx,
                  resampled[c] ? cache->get(comps[c].srcw, ws) : nullptr};
  }
  const Taps* fy = resize ? cache->get(hs, size) : nullptr;
  const Taps* fx = resize ? cache->get(ws, size) : nullptr;
  if (cache->failed) return kNoWeight;
  Axis ay{size, fy, along_y, ncomp}, ax{size, fx, along_x, ncomp};
  auto fit = [&](int rows, int cols) {
    return layout(ay.widest(rows), ax.widest(cols), comps, ncomp, ws, hs, resize);
  };
  int rows = std::min(kTileRows, size), cols = size;
  Layout lay = fit(rows, cols);
  while (lay[15] > kSmemBudget && (rows > 1 || cols > 1)) {
    // Halve the rows or the columns, whichever stages less (rows on a tie).
    const int r = (rows + 1) / 2, c = (cols + 1) / 2;
    const Layout by_rows = r < rows ? fit(r, cols) : Layout{};
    const Layout by_cols = c < cols ? fit(rows, c) : Layout{};
    if (r < rows && (c == cols || by_rows[15] <= by_cols[15])) {
      lay = by_rows;
      rows = r;
    } else {
      lay = by_cols;
      cols = c;
    }
  }
  if (lay[15] > kSmemMax) {
    *bytes = lay[15];
    return kTooLarge;
  }
  const std::vector<Range> ry = ay.ranges(rows), rx = ax.ranges(cols);
  std::vector<int32_t>& rec = out->v;
  const size_t start = rec.size();
  int64_t head[kGeomInts];
  std::fill(head, head + kGeomInts, -1);
  head[kNTiles] = (int64_t)ry.size() * rx.size();
  head[kTiles] = kGeomInts;
  head[kResize] = resize;
  for (int i = 0; i < 16; ++i) head[kS + i] = lay[i];
  head[kTwin] = ncomp == 3 && comps[1] == comps[2];
  for (int64_t v : head) out->put(v);
  for (const Range& y : ry)
    for (const Range& x : rx) {
      int64_t t[kTileInts] = {y[0], y[1], x[0], x[1], y[2], y[3], x[2], x[3]};
      for (int c = 0; c < ncomp; ++c) {
        const int64_t* sy = &y[4 + 4 * c];
        const int64_t* sx = &x[4 + 4 * c];
        int64_t* src = &t[kSrc + 4 * c];
        int64_t* pl = &t[kBox + 4 * c];
        src[0] = sy[0], src[1] = sy[1], src[2] = sx[0], src[3] = sx[1];
        pl[0] = sy[2], pl[1] = sy[3], pl[2] = sx[2], pl[3] = sx[3];
      }
      for (int64_t v : t) out->put(v);
    }
  // The tables, each placed once: fy, fx, then each component's cy, cx.
  std::vector<std::pair<int, const Taps*>> tables;
  if (resize) tables.insert(tables.end(), {{kFY, fy}, {kFX, fx}});
  for (int c = 0; c < ncomp; ++c)
    if (resampled[c])
      tables.insert(tables.end(), {{kCY + c, along_y[c].taps}, {kCX + c, along_x[c].taps}});
  std::vector<std::pair<const Taps*, int64_t>> placed;
  for (auto& [slot, taps] : tables) {
    int64_t at = -1;
    for (auto& [p, where] : placed)
      if (p == taps) at = where;
    if (at < 0) {
      at = (int64_t)(rec.size() - start);
      placed.push_back({taps, at});
      out->put((int64_t)taps->first.size());
      out->put(taps->k);
      rec.insert(rec.end(), taps->first.begin(), taps->first.end());
      rec.insert(rec.end(), taps->count.begin(), taps->count.end());
      const size_t w = rec.size();
      rec.resize(w + taps->w.size());
      std::memcpy(&rec[w], taps->w.data(), 4 * taps->w.size());
    }
    rec[start + slot] = (int32_t)at;
  }
  return (int64_t)(rec.size() - start);
}

// Geometry records made for earlier batches, by geometry and size, so a
// batch whose images repeat geometries seen before (a camera's few sizes)
// copies their records; it starts over once it holds kKeptGeometries.
constexpr size_t kKeptGeometries = 256;
using KeptKey = std::array<int32_t, 4 + 4 * kMaxComps>;  // size, then the batch key
std::mutex kept_lock;
std::map<KeptKey, std::vector<int32_t>> kept;

template <typename Key>
KeptKey kept_key(const Key& key, int size) {
  KeptKey k;
  k[0] = size;
  std::copy(key.begin(), key.end(), k.begin() + 1);
  return k;
}

bool copy_kept(const KeptKey& k, std::vector<int32_t>* out) {
  std::lock_guard<std::mutex> hold(kept_lock);
  auto it = kept.find(k);
  if (it == kept.end()) return false;
  out->insert(out->end(), it->second.begin(), it->second.end());
  return true;
}

void put_kept(const KeptKey& k, std::vector<int32_t>::const_iterator a,
              std::vector<int32_t>::const_iterator b) {
  std::lock_guard<std::mutex> hold(kept_lock);
  if (kept.size() >= kKeptGeometries) kept.clear();
  kept.emplace(k, std::vector<int32_t>(a, b));
}

// What this thread's last call built, for dmlc_jpeg_plan_take (its
// storage kept from call to call).
thread_local Out last;

int64_t keep(int64_t rc) {
  if (rc >= 0 && last.overflow) rc = kOverflow;
  return rc < 0 ? rc : (int64_t)last.v.size();
}

}  // namespace

// resample_taps(in, out) without its zero taps: first[out], count[out] and
// the weights, out rows of k, into w (when out * k <= cap). Returns k.
extern "C" int64_t dmlc_jpeg_taps(int in, int out, int32_t* first, int32_t* count, float* w,
                                  int64_t cap) {
  if (in <= 0 || out <= 0) return kBadArgs;
  Taps t;
  if (!trimmed_taps(in, out, &t)) return kNoWeight;
  std::copy(t.first.begin(), t.first.end(), first);
  std::copy(t.count.begin(), t.count.end(), count);
  if ((int64_t)t.w.size() <= cap) std::copy(t.w.begin(), t.w.end(), w);
  return t.k;
}

// One geometry's record (comps: ncomp x (srcw, srch, fx, fy)). Returns its
// length, or kTooLarge with 0 and the 1x1 tile's bytes kept (2 values).
extern "C" int64_t dmlc_jpeg_geometry_plan(int ncomp, int ws, int hs, const int32_t* comps,
                                           int size) {
  if (ncomp < 1 || ncomp > kMaxComps || ws <= 0 || hs <= 0 || size <= 0) return kBadArgs;
  Comp cs[kMaxComps];
  for (int c = 0; c < ncomp; ++c)
    cs[c] = {comps[4 * c], comps[4 * c + 1], comps[4 * c + 2], comps[4 * c + 3]};
  TapCache cache;
  last.v.clear();
  last.overflow = false;
  int64_t bytes = 0;
  const int64_t rc = geometry_plan(ncomp, ws, hs, cs, size, &cache, &last, &bytes);
  if (rc == kTooLarge) last.v = {0, (int32_t)std::min<int64_t>(bytes, INT32_MAX)};
  return keep(rc);
}

// The plan of a batch of n images: img4 is n x (status, ncomp, ws, hs),
// comp6 is n * kMaxComps x (bw, bh, srcw, srch, fx, fy). The plan: the
// header (n, runs, tiles, shared memory), each image's first tile (a
// prefix of n + 1), the offset of each image's geometry record (-1 for a
// refused image), each component record's first IDCT run (a prefix of
// kMaxComps * n + 1), then one record for each distinct geometry. Returns
// its length, or kTooLarge with the image and its 1x1 tile's bytes kept.
extern "C" int64_t dmlc_jpeg_batch_plan(const int32_t* img4, const int32_t* comp6, int n,
                                        int size) {
  if (n < 0 || size <= 0) return kBadArgs;
  using Key = std::array<int32_t, 3 + 4 * kMaxComps>;
  const int64_t head = kPlanHdr + (n + 1) + n + (kMaxComps * n + 1);
  std::vector<int64_t> plan(head, 0);
  int64_t* tile_start = &plan[kPlanHdr];
  int64_t* geom_at = tile_start + n + 1;
  int64_t* run_start = geom_at + n;
  std::map<Key, std::array<int64_t, 3>> geoms;  // key -> first image, offset, tiles
  std::vector<Key> keys(n);
  for (int i = 0; i < n; ++i) {
    const int32_t* im = img4 + 4 * i;
    const bool taken = im[0] == 0;
    for (int c = 0; c < kMaxComps; ++c) {
      const int32_t* rc = comp6 + 6 * (kMaxComps * i + c);
      const int64_t runs =
          taken && c < im[1] ? (int64_t)rc[1] * ((rc[0] + kRunBlocks - 1) / kRunBlocks) : 0;
      run_start[kMaxComps * i + c + 1] = run_start[kMaxComps * i + c] + runs;
    }
    if (!taken) continue;
    if (im[1] < 1 || im[1] > kMaxComps) return kBadArgs;
    Key& key = keys[i];
    key.fill(0);
    key[0] = im[1], key[1] = im[2], key[2] = im[3];
    for (int c = 0; c < im[1]; ++c)
      for (int f = 0; f < 4; ++f) key[3 + 4 * c + f] = comp6[6 * (kMaxComps * i + c) + 2 + f];
    geoms.emplace(key, std::array<int64_t, 3>{i, 0, 0});
  }
  TapCache cache;
  last.v.assign(head, 0);  // the header and prefixes, filled in below
  last.overflow = false;
  int64_t smem = 0;
  for (auto& [key, g] : geoms) {
    const size_t at = last.v.size();
    const KeptKey kk = kept_key(key, size);
    if (!copy_kept(kk, &last.v)) {
      Comp cs[kMaxComps];
      for (int c = 0; c < key[0]; ++c)
        cs[c] = {key[3 + 4 * c], key[4 + 4 * c], key[5 + 4 * c], key[6 + 4 * c]};
      int64_t bytes = 0;
      const int64_t rc = geometry_plan(key[0], key[1], key[2], cs, size, &cache, &last, &bytes);
      if (rc == kTooLarge) last.v = {(int32_t)g[0], (int32_t)std::min<int64_t>(bytes, INT32_MAX)};
      if (rc < 0) return keep(rc);
      if (!last.overflow) put_kept(kk, last.v.begin() + at, last.v.end());
    }
    g[1] = (int64_t)at;
    g[2] = last.v[at + kNTiles];
    smem = std::max<int64_t>(smem, last.v[at + kSmem]);
  }
  for (int i = 0; i < n; ++i) {
    const bool taken = img4[4 * i] == 0;
    geom_at[i] = taken ? geoms[keys[i]][1] : -1;
    tile_start[i + 1] = tile_start[i] + (taken ? geoms[keys[i]][2] : 0);
  }
  plan[0] = n;
  plan[1] = run_start[kMaxComps * n];
  plan[2] = tile_start[n];
  plan[3] = smem;
  for (int64_t i = 0; i < head; ++i) {
    last.overflow |= plan[i] < INT32_MIN || plan[i] > INT32_MAX;
    last.v[i] = (int32_t)plan[i];
  }
  return keep(0);
}

// Forgets the kept geometry records (the next batch makes each anew).
extern "C" void dmlc_jpeg_plan_forget() {
  std::lock_guard<std::mutex> hold(kept_lock);
  kept.clear();
}

// Copies the first n values of what this thread's last call built.
extern "C" int64_t dmlc_jpeg_plan_take(int32_t* out, int64_t n) {
  n = std::min<int64_t>(n, (int64_t)last.v.size());
  std::memcpy(out, last.v.data(), 4 * n);
  return n;
}
