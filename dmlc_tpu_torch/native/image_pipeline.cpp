// Native image pipeline: JPEG decode + triangle-filter resize, thread-pooled.
//
// This is the TPU framework's data-plane hot path. The reference performs the
// same work inside libtorch via tch-rs (`imagenet::load_image_and_resize`,
// reference src/services.rs:492) at one image per RPC; here a single call
// decodes and resizes a whole shard in parallel so the host keeps up with a
// >10k img/s chip (SURVEY.md §7 hard part b).
//
// Decode: libjpeg with scale_denom selection — when the source is much larger
// than the target, libjpeg decodes at 1/2, 1/4, or 1/8 scale directly from
// the DCT coefficients, which is the single biggest throughput lever.
// Resize: separable triangle-filter resampling (PIL BILINEAR semantics: the
// filter support widens by the downscale ratio, so it is a proper
// antialiasing resample, not naive point-sampled bilerp) — keeps accuracy
// parity with the Python/PIL path.
// Threading: one PERSISTENT worker pool shared by every call (see DecodePool
// below). The original design spawned and joined fresh std::threads per
// dmlc_decode_resize_batch call, which at serving steady state (one call per
// shard, many shards per second) paid thread churn and a fresh decode
// scratch allocation on every batch.
//
// C ABI only; Python binds with ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstddef>/<cstdio> first (size_t, FILE)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into an RGB buffer. Picks the largest libjpeg
// scale_denom that still yields >= target on both sides. Returns true on
// success; fills w/h.
bool decode_jpeg(const char* path, int target, std::vector<uint8_t>& rgb,
                 int& w, int& h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // Every C++ object with a destructor is constructed BEFORE setjmp:
  // longjmp from the libjpeg error handler unwinds no C++ frames, so an
  // object constructed after setjmp would leak its heap on every corrupt
  // JPEG (and is formally UB to jump over).
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale at M/8 granularity (libjpeg-turbo's scaled IDCT
  // decodes each 8x8 block straight to MxM): smallest M in 1..8 keeping
  // >= target on both sides. Finer than the old {1/2, 1/4, 1/8}: a
  // 256->224 request picks 7/8 and lands EXACTLY on target, so the
  // triangle resample below becomes a memcpy — measured 482 -> ~1,500
  // img/s on this 1-core host (the resample was 2/3 of per-image cost).
  if (target > 0) {
    for (int m = 1; m <= 8; ++m) {
      if ((int)((cinfo.image_width * (unsigned)m + 7) / 8) >= target &&
          (int)((cinfo.image_height * (unsigned)m + 7) / 8) >= target) {
        cinfo.scale_num = m;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  int channels = cinfo.output_components;  // 3 for JCS_RGB
  rgb.resize((size_t)w * h * 3);
  row.resize((size_t)w * channels);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = row.data();
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    uint8_t* dst = rgb.data() + (size_t)(cinfo.output_scanline - 1) * w * 3;
    if (channels == 3) {
      std::memcpy(dst, row.data(), (size_t)w * 3);
    } else {  // grayscale safety net
      for (int x = 0; x < w; ++x) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[x * channels];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Precomputed triangle-filter taps for one output axis (PIL-style BILINEAR:
// support scales with the downscale ratio).
struct Taps {
  std::vector<int> start;      // first source index per output pixel
  std::vector<int> count;      // tap count per output pixel
  std::vector<float> weights;  // concatenated weights
  std::vector<int> offset;     // offset into weights per output pixel
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.offset.resize(out_size);
  double scale = (double)in_size / out_size;
  double support = std::max(1.0, scale);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, (int)std::floor(center - support));
    int hi = std::min(in_size, (int)std::ceil(center + support));
    t.start[i] = lo;
    t.count[i] = hi - lo;
    t.offset[i] = (int)t.weights.size();
    double total = 0.0;
    std::vector<double> ws(hi - lo);
    for (int j = lo; j < hi; ++j) {
      double d = std::abs((j + 0.5 - center) / (support > 1.0 ? scale : 1.0));
      double wgt = d < 1.0 ? 1.0 - d : 0.0;
      ws[j - lo] = wgt;
      total += wgt;
    }
    if (total <= 0.0) {  // degenerate: nearest
      int j = std::clamp((int)center, lo, hi - 1);
      std::fill(ws.begin(), ws.end(), 0.0);
      ws[j - lo] = total = 1.0;
    }
    for (double wgt : ws) t.weights.push_back((float)(wgt / total));
  }
  return t;
}

// Separable resample: [h, w, 3] u8 -> [out, out, 3] u8.
void resize_triangle(const uint8_t* src, int w, int h, int out, uint8_t* dst) {
  if (w == out && h == out) {  // already staged (device-resize mode)
    std::memcpy(dst, src, (size_t)out * out * 3);
    return;
  }
  Taps tx = make_taps(w, out);
  Taps ty = make_taps(h, out);
  // Horizontal pass: [h, out, 3] float.
  std::vector<float> tmp((size_t)h * out * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + (size_t)y * w * 3;
    float* trow = tmp.data() + (size_t)y * out * 3;
    for (int x = 0; x < out; ++x) {
      float acc[3] = {0, 0, 0};
      const float* wts = tx.weights.data() + tx.offset[x];
      for (int k = 0; k < tx.count[x]; ++k) {
        const uint8_t* p = srow + (size_t)(tx.start[x] + k) * 3;
        float wgt = wts[k];
        acc[0] += wgt * p[0];
        acc[1] += wgt * p[1];
        acc[2] += wgt * p[2];
      }
      trow[3 * x] = acc[0];
      trow[3 * x + 1] = acc[1];
      trow[3 * x + 2] = acc[2];
    }
  }
  // Vertical pass -> u8 out.
  for (int y = 0; y < out; ++y) {
    const float* wts = ty.weights.data() + ty.offset[y];
    uint8_t* drow = dst + (size_t)y * out * 3;
    for (int x = 0; x < out; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ty.count[y]; ++k) {
        const float* p = tmp.data() + ((size_t)(ty.start[y] + k) * out + x) * 3;
        float wgt = wts[k];
        acc[0] += wgt * p[0];
        acc[1] += wgt * p[1];
        acc[2] += wgt * p[2];
      }
      for (int c = 0; c < 3; ++c)
        drow[3 * x + c] =
            (uint8_t)std::clamp((int)std::lround(acc[c]), 0, 255);
    }
  }
}

// ---- persistent decode pool ------------------------------------------------
//
// A batch call publishes one BatchJob; pool workers (and the submitting
// thread itself) claim item indices via fetch_add and decode into the
// caller's output arena. The submitter blocks until every claimed item is
// finished AND no worker is still inside the job (the `active` count —
// without it a worker between claiming nothing and returning could touch
// the stack-allocated job after the submitter destroyed it). Worker decode
// scratch (`rgb`) lives for the thread's lifetime, so steady-state batches
// allocate nothing per image beyond libjpeg internals.

struct BatchJob {
  const char** paths = nullptr;
  int n = 0;
  int size = 0;
  uint8_t* out = nullptr;
  int* status = nullptr;
  std::atomic<int> next{0};  // item claim cursor
  int done = 0;              // finished items   (guarded by DecodePool::mu_)
  int failures = 0;          // failed decodes   (guarded by DecodePool::mu_)
  int active = 0;            // workers inside the job (guarded by mu_)
  std::condition_variable done_cv;
};

class DecodePool {
 public:
  static DecodePool& instance() {
    // Deliberately leaked: a static destructor would tear the mutex/cv down
    // under workers still blocked in wait() at process exit. Reachable via
    // this pointer, so LeakSanitizer stays quiet; dmlc_pool_shutdown() is
    // the orderly teardown for harnesses that want one.
    static DecodePool* pool = new DecodePool();
    return *pool;
  }

  int run(const char** paths, int n, int size, uint8_t* out, int* status,
          int n_threads) {
    ensure(n_threads);
    BatchJob job;
    job.paths = paths;
    job.n = n;
    job.size = size;
    job.out = out;
    job.status = status;
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push_back(&job);
    }
    cv_.notify_all();
    // The submitting thread works the job too: a pool busy with another
    // batch (or shut down) degenerates to the old inline decode instead of
    // sleeping on the queue.
    std::vector<uint8_t> scratch;
    int finished = 0, failed = 0;
    work(&job, scratch, finished, failed);
    std::unique_lock<std::mutex> lk(mu_);
    job.done += finished;
    job.failures += failed;
    job.done_cv.wait(lk, [&] { return job.done >= job.n && job.active == 0; });
    // If no worker ever popped it (fully drained by the submitter), the
    // exhausted job may still sit in the queue; remove before it goes out
    // of scope.
    for (auto it = jobs_.begin(); it != jobs_.end(); ++it) {
      if (*it == &job) {
        jobs_.erase(it);
        break;
      }
    }
    return job.failures;
  }

  // Grow-only sizing: batches of different sizes share one pool, and
  // shrinking for a small call would reintroduce exactly the thread churn
  // this pool exists to end. n_threads <= 0 asks for hardware_concurrency.
  void ensure(int n_threads) {
    size_t want = n_threads > 0
                      ? (size_t)n_threads
                      : (size_t)std::max(1u, std::thread::hardware_concurrency());
    want = std::min(want, (size_t)64);
    std::lock_guard<std::mutex> lk(mu_);
    if (stopping_) return;  // mid-shutdown callers run inline via run()
    while (workers_.size() < want)
      workers_.emplace_back([this] { worker_loop(); });
  }

  int size() {
    std::lock_guard<std::mutex> lk(mu_);
    return (int)workers_.size();
  }

  // Join every worker. Restartable: the next ensure() re-grows the pool.
  void shutdown() {
    std::vector<std::thread> doomed;
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
      doomed.swap(workers_);
    }
    cv_.notify_all();
    for (auto& t : doomed) t.join();
    std::lock_guard<std::mutex> lk(mu_);
    stopping_ = false;
  }

 private:
  void worker_loop() {
    std::vector<uint8_t> scratch;  // reused for every image this thread decodes
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return stopping_ || !jobs_.empty(); });
      if (stopping_) return;
      BatchJob* job = jobs_.front();
      if (job->next.load(std::memory_order_relaxed) >= job->n) {
        // Fully claimed: out of the queue; stragglers finish via `active`.
        jobs_.pop_front();
        continue;
      }
      ++job->active;
      lk.unlock();
      int finished = 0, failed = 0;
      work(job, scratch, finished, failed);
      lk.lock();
      --job->active;
      job->done += finished;
      job->failures += failed;
      if (job->done >= job->n && job->active == 0) job->done_cv.notify_all();
    }
  }

  // Claim and decode items until the job's cursor is exhausted.
  static void work(BatchJob* job, std::vector<uint8_t>& scratch,
                   int& finished, int& failed) {
    const size_t stride = (size_t)job->size * job->size * 3;
    for (;;) {
      int i = job->next.fetch_add(1);
      if (i >= job->n) return;
      int w = 0, h = 0;
      if (decode_jpeg(job->paths[i], job->size, scratch, w, h)) {
        resize_triangle(scratch.data(), w, h, job->size,
                        job->out + stride * i);
        job->status[i] = 0;
      } else {
        std::memset(job->out + stride * i, 0, stride);
        job->status[i] = 1;
        ++failed;
      }
      ++finished;
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<BatchJob*> jobs_;
  std::vector<std::thread> workers_;
  bool stopping_ = false;
};

}  // namespace

extern "C" {

// Decode + resize a batch of JPEG files into out[n, size, size, 3] uint8 —
// the caller-owned output arena (numpy buffers on the Python side, reused
// across batches). paths: n C strings. status[i]: 0 ok, 1 decode failure.
// n_threads sizes the persistent pool (grow-only; <= 0 means
// hardware_concurrency). Returns count of failures.
int dmlc_decode_resize_batch(const char** paths, int n, int size,
                             uint8_t* out, int* status, int n_threads) {
  if (n <= 0) return 0;
  return DecodePool::instance().run(paths, n, size, out, status, n_threads);
}

// Current persistent-pool worker count (0 before the first batch / after
// shutdown) — observability for tests and the Python binding.
int dmlc_pool_size() { return DecodePool::instance().size(); }

// Join the pool's workers (restartable: the next batch call re-grows it).
// Called by the sanitizer harness so teardown runs under TSan/ASan too.
void dmlc_pool_shutdown() { DecodePool::instance().shutdown(); }

// Version tag so Python can detect stale builds.
int dmlc_native_abi_version() { return 2; }

}  // extern "C"
