// Native AOTInductor serving host: load a torch.export serving program that
// AOTInductor compiled into a package, stage its inputs, run, read results
// back — no Python interpreter anywhere in the process.
//
// Counterpart of native/pjrt_host.cpp. models/aoti_bundle.py writes the
// bundle: program.pt2 (the package, weights as program INPUTS), an args.txt
// manifest ("dtype:d0,d1,...[=raw_file]" per program input, in the
// program's input order) and arg<N>.raw weight files, so weights ship
// SEPARATE from the program, exactly like the SDFS deployment. libtorch's
// AOTIModelPackageLoader loads the package's compiled model (its kernels
// built for the device it was exported on) and runs it.
//
// Usage:
//   aoti_host probe [<program.pt2>]
//       one JSON line: libtorch's version, whether CUDA is present, the
//       device count and name, whether this build has a JPEG decoder and,
//       given a package, whether it loads. Never crashes — the report IS
//       the product.
//   aoti_host run <bundle_dir> [--iters N]
//       stage args.txt's inputs (zeros, or the named raw files) on the
//       package's device, run once and print the outputs' shapes and
//       values as JSON; --iters N then times N back-to-back runs (the last
//       output read back as the end-of-work barrier) and prints the rate.
//   aoti_host serve <bundle_dir> [--dir d] [--repeat N] [--threads N]
//       the RESIDENT serving loop: load the package and stage the weights
//       ONCE, then decode JPEGs with the in-process native decoder
//       (image_pipeline.cpp, linked into this binary where libjpeg is
//       present), stage u8 batches, run, and emit top-1/prob — first over
//       --dir, then one request (whitespace-separated JPEG paths) per stdin
//       line until EOF. --repeat N measures the sustained JPEG->top-1 rate.
//       A host built without the decoder refuses --dir and path requests
//       with an error that says so; it never falls back.
//   aoti_host stage <bundle_dir> --dir d --out staged.raw [--threads N]
//       hermetic half of serve (no package, no device): decode --dir into
//       the manifest's image-input layout (padded by repetition like the
//       exporter) and write the exact bytes serve would hand the program.
//   aoti_host frame-check
//       hermetic self-test of serve's stdin request framing.
//
// Build: dmlc_tpu_torch/ops/_build_host.py (g++ against the torch install's
// headers and libraries; -DDMLC_WITH_CUDA where torch has CUDA,
// -DDMLC_WITH_DECODER where libjpeg is found).

#include <dirent.h>
#include <ctime>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <algorithm>
#include <exception>
#include <memory>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <ATen/detail/CUDAHooksInterface.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/version.h>
#ifdef DMLC_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#endif

#ifdef DMLC_WITH_DECODER
// Native JPEG decode + resize (image_pipeline.cpp, linked into this
// binary) — the same code path the port's ctypes binding serves from.
extern "C" int dmlc_decode_resize_batch(const char** paths, int n, int size,
                                        uint8_t* out, int* status,
                                        int n_threads);
constexpr bool kHasDecoder = true;
#else
constexpr bool kHasDecoder = false;
#endif

namespace {

const char kNoDecoder[] =
    "this aoti_host was built without a JPEG decoder (no libjpeg where it "
    "was built): JPEG paths are refused";

// JSON string escaping for messages embedded in a report.
std::string JsonEscape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') { out += '\\'; out += c; }
    else if (c == '\n') out += "\\n";
    else if (static_cast<unsigned char>(c) < 0x20) out += ' ';
    else out += c;
  }
  return out;
}

bool ReadFile(const std::string& path, std::vector<char>* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) { std::fprintf(stderr, "aoti_host: cannot open %s\n", path.c_str()); return false; }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n);
  bool ok = !n || std::fread(out->data(), 1, n, f) == static_cast<size_t>(n);
  std::fclose(f);
  if (!ok) std::fprintf(stderr, "aoti_host: short read on %s\n", path.c_str());
  return ok;
}

double Seconds(const timespec& a, const timespec& b) {
  return (b.tv_sec - a.tv_sec) + (b.tv_nsec - a.tv_nsec) * 1e-9;
}

// ---------------------------------------------------------------------------
// args.txt: the staging contract
// ---------------------------------------------------------------------------

struct DtypeSpec {
  at::ScalarType type;
  size_t bytes;
  const char* name;
};

bool ParseDtype(const std::string& s, DtypeSpec* out) {
  if (s == "u8") { *out = {at::kByte, 1, "u8"}; return true; }
  if (s == "f32") { *out = {at::kFloat, 4, "f32"}; return true; }
  if (s == "i32") { *out = {at::kInt, 4, "i32"}; return true; }
  if (s == "bf16") { *out = {at::kBFloat16, 2, "bf16"}; return true; }
  return false;
}

const char* DtypeName(at::ScalarType t) {
  switch (t) {
    case at::kByte: return "u8";
    case at::kFloat: return "f32";
    case at::kInt: return "i32";
    case at::kBFloat16: return "bf16";
    case at::kLong: return "i64";
    default: return "other";
  }
}

struct ArgSpec {
  DtypeSpec dt;
  std::vector<int64_t> dims;
  int64_t total = 1;
  std::string file;  // empty: zeros
};

bool ParseArgSpec(const std::string& line, ArgSpec* a) {
  std::string spec = line, file;
  auto eq = line.find('=');
  if (eq != std::string::npos) { spec = line.substr(0, eq); file = line.substr(eq + 1); }
  auto colon = spec.find(':');
  if (colon == std::string::npos || !ParseDtype(spec.substr(0, colon), &a->dt)) return false;
  std::string dims = spec.substr(colon + 1);
  size_t b = 0;
  while (b < dims.size()) {
    size_t e = dims.find(',', b);
    if (e == std::string::npos) e = dims.size();
    char* end = nullptr;
    long long d = std::strtoll(dims.c_str() + b, &end, 10);
    if (end != dims.c_str() + e || d < 0) return false;
    a->dims.push_back(d);
    a->total *= d;
    b = e + 1;
  }
  a->file = file;
  return true;
}

struct Manifest {
  std::vector<ArgSpec> args;
  int image_arg = -1;  // the first u8 rank-4 input: the image batch
  int64_t batch = 0, size = 0;
};

bool LoadManifest(const std::string& bundle, Manifest* m) {
  FILE* f = std::fopen((bundle + "/args.txt").c_str(), "rb");
  if (!f) {
    std::fprintf(stderr, "aoti_host: no args.txt in %s\n", bundle.c_str());
    return false;
  }
  char line[512];
  while (std::fgets(line, sizeof(line), f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.empty() || s[0] == '#') continue;
    ArgSpec a;
    if (!ParseArgSpec(s, &a)) {
      std::fprintf(stderr, "aoti_host: bad args.txt line: %s\n", s.c_str());
      std::fclose(f);
      return false;
    }
    if (a.dt.type == at::kByte && a.dims.size() == 4 && m->image_arg < 0) {
      m->image_arg = static_cast<int>(m->args.size());
      m->batch = a.dims[0];
      m->size = a.dims[1];
    }
    m->args.push_back(std::move(a));
  }
  std::fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// The resident half: package + device + staged inputs
// ---------------------------------------------------------------------------

struct Host {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device{c10::kCPU};
};

int Boot(const std::string& bundle, Host* h) {
  std::string package = bundle + "/program.pt2";
  try {
    h->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(package);
    auto md = h->loader->get_metadata();
    auto it = md.find("AOTI_DEVICE_KEY");
    if (it != md.end() && it->second == "cuda") h->device = c10::Device(c10::kCUDA, 0);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_host: cannot load %s: %s\n", package.c_str(), e.what());
    return 1;
  }
  return 0;
}

at::Tensor StageTensor(const Host& h, const ArgSpec& a, const void* bytes) {
  auto opts = at::TensorOptions().dtype(a.dt.type);
  at::Tensor host = at::from_blob(const_cast<void*>(bytes), a.dims, opts).clone();
  return host.to(h.device);
}

// Stage every manifest argument from its raw file (zeros when file-less).
int StageManifestArgs(const Host& h, const Manifest& m, const std::string& bundle,
                      std::vector<at::Tensor>* out) {
  for (const ArgSpec& a : m.args) {
    std::vector<char> input(a.total * a.dt.bytes, 0);
    if (!a.file.empty()) {
      std::string path = bundle + "/" + a.file;
      std::vector<char> raw;
      if (!ReadFile(path, &raw)) return 1;
      if (raw.size() != input.size()) {
        std::fprintf(stderr, "aoti_host: %s is %zu bytes, want %zu\n",
                     path.c_str(), raw.size(), input.size());
        return 1;
      }
      input = std::move(raw);
    }
    out->push_back(StageTensor(h, a, input.data()));
  }
  return 0;
}

int Execute(const Host& h, const std::vector<at::Tensor>& inputs,
            std::vector<at::Tensor>* outs) {
  try {
    *outs = h.loader->run(inputs);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_host: run failed: %s\n", e.what());
    return 1;
  }
  return 0;
}

void PrintValues(const at::Tensor& t, size_t limit) {
  at::Tensor c = t.to(at::kCPU).contiguous().reshape({-1});
  size_t n = std::min(static_cast<size_t>(c.numel()), limit);
  for (size_t i = 0; i < n; ++i) {
    if (c.scalar_type() == at::kInt || c.scalar_type() == at::kLong)
      std::printf("%s%lld", i ? ", " : "", static_cast<long long>(c[i].item<int64_t>()));
    else
      std::printf("%s%.9g", i ? ", " : "", c[i].item<double>());
  }
}

int Run(int argc, char** argv) {
  std::string bundle = argv[2];
  int iters = 1;
  for (int i = 3; i + 1 < argc; i += 2) {
    if (std::strcmp(argv[i], "--iters") == 0) iters = std::atoi(argv[i + 1]);
  }
  if (iters < 1) iters = 1;

  Manifest manifest;
  if (!LoadManifest(bundle, &manifest)) return 1;
  Host host;
  if (Boot(bundle, &host)) return 1;
  std::vector<at::Tensor> inputs;
  if (StageManifestArgs(host, manifest, bundle, &inputs)) return 1;

  std::vector<at::Tensor> outs;
  if (Execute(host, inputs, &outs)) return 1;
  std::printf("{\"device\": \"%s\", \"outputs\": [", host.device.str().c_str());
  for (size_t i = 0; i < outs.size(); ++i) {
    const at::Tensor& o = outs[i];
    std::printf("%s{\"shape\": [", i ? ", " : "");
    for (int64_t d = 0; d < o.dim(); ++d)
      std::printf("%s%lld", d ? ", " : "", static_cast<long long>(o.size(d)));
    std::printf("], \"dtype\": \"%s\", \"head\": [", DtypeName(o.scalar_type()));
    PrintValues(o, 4);
    std::printf("]");
    if (o.numel() <= 4096) {
      std::printf(", \"values\": [");
      PrintValues(o, 4096);
      std::printf("]");
    }
    std::printf("}");
  }
  std::printf("]}\n");
  std::fflush(stdout);

  if (iters > 1) {
    // Back-to-back runs on the device's stream; only a host readback of
    // the LAST output is a true end-of-work barrier.
    timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int i = 0; i < iters; ++i)
      if (Execute(host, inputs, &outs)) return 1;
    at::Tensor barrier = outs[0].to(at::kCPU);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double sec = Seconds(t0, t1);
    long long images = manifest.image_arg >= 0 ? manifest.batch * iters : 0;
    std::printf("{\"iters\": %d, \"total_s\": %.6f, \"ms_per_exec\": %.6f, "
                "\"batch\": %lld, \"images_per_s\": %.3f}\n",
                iters, sec, sec * 1e3 / iters, static_cast<long long>(manifest.batch),
                images / sec);
    std::fflush(stdout);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// serve / stage: the resident JPEG->top-1 loop and its hermetic half
// ---------------------------------------------------------------------------

// Read one stdin request line of ANY length: fgets chunks are appended
// until the newline arrives, so a request longer than one buffer is never
// split into several bogus requests (each with a truncated path at the
// seam) answered by several reply lines. Returns false at EOF with nothing
// pending; a final unterminated line still counts as one request.
bool ReadRequestLine(std::string* line) {
  line->clear();
  char chunk[65536];
  while (std::fgets(chunk, sizeof(chunk), stdin)) {
    line->append(chunk);
    if (!line->empty() && line->back() == '\n') return true;
  }
  return !line->empty();
}

std::vector<std::string> SplitWhitespace(const std::string& line) {
  std::vector<std::string> out;
  size_t b = 0;
  while ((b = line.find_first_not_of(" \t\r\n", b)) != std::string::npos) {
    size_t e = line.find_first_of(" \t\r\n", b);
    if (e == std::string::npos) e = line.size();
    out.push_back(line.substr(b, e - b));
    b = e;
  }
  return out;
}

// Hermetic self-test of the request framing (no package, no device): echo
// one JSON line per stdin request with its token count.
int FrameCheck() {
  std::string line;
  while (ReadRequestLine(&line)) {
    std::vector<std::string> toks = SplitWhitespace(line);
    if (toks.empty()) continue;
    std::printf("{\"paths\": %zu, \"bytes\": %zu}\n", toks.size(), line.size());
  }
  std::fflush(stdout);
  return 0;
}

bool HasJpegSuffix(const std::string& name) {
  auto dot = name.rfind('.');
  if (dot == std::string::npos) return false;
  std::string ext = name.substr(dot + 1);
  std::transform(ext.begin(), ext.end(), ext.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  return ext == "jpg" || ext == "jpeg";
}

std::vector<std::string> ListJpegs(const std::string& dir) {
  std::vector<std::string> out;
  DIR* d = opendir(dir.c_str());
  if (!d) {
    std::fprintf(stderr, "aoti_host: cannot open dir %s\n", dir.c_str());
    return out;
  }
  while (dirent* e = readdir(d)) {
    std::string name = e->d_name;
    if (HasJpegSuffix(name)) out.push_back(dir + "/" + name);
  }
  closedir(d);
  std::sort(out.begin(), out.end());
  return out;
}

// Decode up to `batch` paths into out[batch, size, size, 3] u8, padding by
// repetition (the exporter's contract: aoti_bundle.py pads with np.tile).
// Returns the number of decode FAILURES among the real (unpadded) slots;
// `failed` (optional) receives the per-real-slot failure flags.
int DecodePadded(const std::vector<std::string>& paths, int64_t batch,
                 int64_t size, uint8_t* out, int threads,
                 std::vector<bool>* failed = nullptr) {
  std::vector<int> status(batch, 0);
#ifdef DMLC_WITH_DECODER
  std::vector<const char*> cpaths(batch);
  for (int64_t i = 0; i < batch; ++i)
    cpaths[i] = paths[i % paths.size()].c_str();
  dmlc_decode_resize_batch(cpaths.data(), static_cast<int>(batch),
                           static_cast<int>(size), out, status.data(), threads);
#else
  (void)size; (void)out; (void)threads;
  std::fill(status.begin(), status.end(), 1);
#endif
  int failures = 0;
  if (failed) failed->assign(paths.size(), false);
  for (size_t i = 0; i < paths.size() && i < static_cast<size_t>(batch); ++i) {
    if (status[i] != 0) {
      ++failures;
      if (failed) (*failed)[i] = true;
    }
  }
  return failures;
}

void PrintBatchResult(const std::vector<std::string>& files,
                      const std::vector<int32_t>& top1,
                      const std::vector<float>& prob,
                      const std::vector<bool>& decode_failed) {
  std::printf("{\"files\": [");
  for (size_t i = 0; i < files.size(); ++i) {
    auto slash = files[i].rfind('/');
    std::string base = slash == std::string::npos ? files[i] : files[i].substr(slash + 1);
    std::printf("%s\"%s\"", i ? ", " : "", JsonEscape(base).c_str());
  }
  std::printf("], \"top1\": [");
  for (size_t i = 0; i < files.size() && i < top1.size(); ++i)
    std::printf("%s%d", i ? ", " : "", top1[i]);
  std::printf("], \"prob\": [");
  for (size_t i = 0; i < files.size() && i < prob.size(); ++i)
    std::printf("%s%.6g", i ? ", " : "", prob[i]);
  std::printf("]");
  // In-protocol failure marker: a zero-filled slot's "prediction" must not
  // read as a confident answer to a stdout consumer.
  bool any = false;
  for (bool f : decode_failed) any |= f;
  if (any) {
    std::printf(", \"decode_failed\": [");
    bool first = true;
    for (size_t i = 0; i < decode_failed.size(); ++i) {
      if (!decode_failed[i]) continue;
      std::printf("%s%zu", first ? "" : ", ", i);
      first = false;
    }
    std::printf("]");
  }
  std::printf("}\n");
  std::fflush(stdout);
}

// The hermetic half of serve: decode --dir into the manifest's image-input
// layout and write the raw bytes serve would stage.
int Stage(int argc, char** argv) {
  std::string bundle = argv[2];
  const char* dir = nullptr;
  const char* out_path = nullptr;
  int threads = 0;
  for (int i = 3; i + 1 < argc; i += 2) {
    if (std::strcmp(argv[i], "--dir") == 0) dir = argv[i + 1];
    else if (std::strcmp(argv[i], "--out") == 0) out_path = argv[i + 1];
    else if (std::strcmp(argv[i], "--threads") == 0) threads = std::atoi(argv[i + 1]);
  }
  if (!dir || !out_path) {
    std::fprintf(stderr, "aoti_host: stage needs --dir and --out\n");
    return 2;
  }
  if (!kHasDecoder) {
    std::fprintf(stderr, "aoti_host: %s\n", kNoDecoder);
    return 1;
  }
  Manifest m;
  if (!LoadManifest(bundle, &m)) return 1;
  if (m.image_arg < 0) {
    std::fprintf(stderr, "aoti_host: manifest has no u8 image input\n");
    return 1;
  }
  std::vector<std::string> files = ListJpegs(dir);
  if (files.empty()) {
    std::fprintf(stderr, "aoti_host: no JPEGs in %s\n", dir);
    return 1;
  }
  if (static_cast<int64_t>(files.size()) > m.batch) files.resize(m.batch);
  std::vector<uint8_t> staged(m.batch * m.size * m.size * 3);
  int failures = DecodePadded(files, m.batch, m.size, staged.data(), threads);
  FILE* f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(staged.data(), 1, staged.size(), f) != staged.size()) {
    std::fprintf(stderr, "aoti_host: cannot write %s\n", out_path);
    if (f) std::fclose(f);
    return 1;
  }
  std::fclose(f);
  std::printf(
      "{\"batch\": %lld, \"size\": %lld, \"files\": %zu, \"padded\": %lld, "
      "\"decode_failures\": %d, \"bytes\": %zu}\n",
      static_cast<long long>(m.batch), static_cast<long long>(m.size),
      files.size(), static_cast<long long>(m.batch) - static_cast<long long>(files.size()),
      failures, staged.size());
  return failures ? 1 : 0;
}

// The resident serving loop: load the package and stage the weights ONCE;
// then:
//   1. --dir: classify every JPEG under it, one JSON line per batch;
//   2. --repeat N: N passes over the dir measuring the sustained
//      JPEG->top-1 rate (the last batch read back as the barrier);
//   3. stdin: one request per line (whitespace-separated JPEG paths),
//      answered with one JSON line, until EOF.
int Serve(int argc, char** argv) {
  std::string bundle = argv[2];
  const char* dir = nullptr;
  int repeat = 0;
  int threads = 0;
  for (int i = 3; i + 1 < argc; i += 2) {
    if (std::strcmp(argv[i], "--dir") == 0) dir = argv[i + 1];
    else if (std::strcmp(argv[i], "--repeat") == 0) repeat = std::atoi(argv[i + 1]);
    else if (std::strcmp(argv[i], "--threads") == 0) threads = std::atoi(argv[i + 1]);
  }
  if (repeat > 0 && !dir) {
    std::fprintf(stderr,
                 "aoti_host: --repeat needs --dir (nothing to measure); "
                 "refusing to fall through to the stdin loop\n");
    return 2;
  }
  if (dir && !kHasDecoder) {
    std::fprintf(stderr, "aoti_host: --dir refused: %s\n", kNoDecoder);
    return 2;
  }

  Manifest manifest;
  if (!LoadManifest(bundle, &manifest)) return 1;
  if (manifest.image_arg < 0) {
    std::fprintf(stderr, "aoti_host: manifest has no u8 image input to serve\n");
    return 1;
  }
  const int64_t B = manifest.batch, S = manifest.size;
  if (B <= 0 || S <= 0) {
    std::fprintf(stderr, "aoti_host: degenerate image geometry batch=%lld size=%lld\n",
                 static_cast<long long>(B), static_cast<long long>(S));
    return 1;
  }
  Host host;
  if (Boot(bundle, &host)) return 1;
  std::vector<at::Tensor> args;
  if (StageManifestArgs(host, manifest, bundle, &args)) return 1;
  const ArgSpec& image_spec = manifest.args[manifest.image_arg];
  std::fprintf(stderr,
               "aoti_host: serving batch=%lld size=%lld on %s (weights resident%s)\n",
               static_cast<long long>(B), static_cast<long long>(S),
               host.device.str().c_str(),
               kHasDecoder ? ", native decode in-process" : ", no JPEG decoder");

  std::vector<uint8_t> pixels(B * S * S * 3);
  auto for_each_chunk = [B](const std::vector<std::string>& paths, auto fn) -> int {
    for (size_t s = 0; s < paths.size(); s += B) {
      std::vector<std::string> chunk(
          paths.begin() + s,
          paths.begin() + std::min(paths.size(), s + static_cast<size_t>(B)));
      if (int rc = fn(chunk)) return rc;
    }
    return 0;
  };
  // Classify one <=B chunk against the resident weights, APPENDING the
  // per-real-slot results.
  auto classify_chunk = [&](const std::vector<std::string>& chunk,
                            std::vector<int32_t>* top1, std::vector<float>* prob,
                            std::vector<bool>* failed) -> int {
    std::vector<bool> decode_failed;
    int failures = DecodePadded(chunk, B, S, pixels.data(), threads, &decode_failed);
    if (failures)
      std::fprintf(stderr, "aoti_host: %d decode failure(s) in batch\n", failures);
    args[manifest.image_arg] = StageTensor(host, image_spec, pixels.data());
    std::vector<at::Tensor> outs;
    if (Execute(host, args, &outs)) return 1;
    at::Tensor idx = outs[0].to(at::kCPU).to(at::kInt).contiguous();
    at::Tensor p = outs.size() > 1 ? outs[1].to(at::kCPU).to(at::kFloat).contiguous()
                                   : at::zeros({B}, at::kFloat);
    for (size_t i = 0; i < chunk.size(); ++i) {
      top1->push_back(idx.data_ptr<int32_t>()[i]);
      prob->push_back(p.data_ptr<float>()[i]);
      failed->push_back(decode_failed[i]);
    }
    return 0;
  };
  // One request (any size) -> ONE JSON reply line, chunked internally.
  auto classify_request = [&](const std::vector<std::string>& paths) -> int {
    std::vector<int32_t> top1;
    std::vector<float> prob;
    std::vector<bool> failed;
    int rc = for_each_chunk(paths, [&](const std::vector<std::string>& chunk) {
      return classify_chunk(chunk, &top1, &prob, &failed);
    });
    if (rc) return rc;
    PrintBatchResult(paths, top1, prob, failed);
    return 0;
  };

  // Phase 1: classify the directory, one reply line per batch.
  std::vector<std::string> files;
  if (dir) {
    files = ListJpegs(dir);
    if (files.empty()) {
      std::fprintf(stderr, "aoti_host: no JPEGs in %s\n", dir);
      return 1;
    }
    if (for_each_chunk(files, [&](const std::vector<std::string>& chunk) {
          return classify_request(chunk);
        }))
      return 1;
  }

  // Phase 2: sustained-throughput passes; results are not read back per
  // batch, the final batch is, as the end-of-work barrier.
  if (dir && repeat > 0) {
    long long images = 0, decode_failures = 0;
    std::vector<at::Tensor> outs;
    timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int pass = 0; pass < repeat; ++pass) {
      int rc = for_each_chunk(files, [&](const std::vector<std::string>& chunk) {
        decode_failures += DecodePadded(chunk, B, S, pixels.data(), threads);
        args[manifest.image_arg] = StageTensor(host, image_spec, pixels.data());
        if (Execute(host, args, &outs)) return 1;
        images += chunk.size();
        return 0;
      });
      if (rc) return 1;
    }
    if (!outs.empty()) at::Tensor barrier = outs[0].to(at::kCPU);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double sec = Seconds(t0, t1);
    std::printf(
        "{\"images\": %lld, \"total_s\": %.4f, \"jpeg_to_top1_img_s\": %.1f, "
        "\"batch\": %lld, \"passes\": %d, \"decode_failures\": %lld}\n",
        images, sec, images / sec, static_cast<long long>(B), repeat, decode_failures);
    std::fflush(stdout);
  }

  // Phase 3: the long-lived request loop. One physical line = one request
  // at ANY length; EOF ends the process.
  std::string line;
  while (ReadRequestLine(&line)) {
    std::vector<std::string> paths = SplitWhitespace(line);
    if (paths.empty()) continue;
    if (!kHasDecoder) {
      std::printf("{\"error\": \"%s\"}\n", JsonEscape(kNoDecoder).c_str());
      std::fflush(stdout);
      continue;
    }
    if (classify_request(paths)) return 1;  // a failed run is fatal
  }
  return 0;
}

// ---------------------------------------------------------------------------
// probe
// ---------------------------------------------------------------------------

int Probe(const char* package) {
  bool cuda = false, loaded = false;
  int count = 0;
  std::string name, device, error;
  try {
    cuda = at::globalContext().hasCUDA();
    count = cuda ? at::detail::getCUDAHooks().getNumGPUs() : 0;
#ifdef DMLC_WITH_CUDA
    if (count > 0) name = at::cuda::getDeviceProperties(0)->name;
#endif
  } catch (const std::exception& e) {
    error = e.what();
  }
  if (package) {
    try {
      torch::inductor::AOTIModelPackageLoader loader(package);
      auto md = loader.get_metadata();
      auto it = md.find("AOTI_DEVICE_KEY");
      device = it == md.end() ? "" : it->second;
      loaded = true;
    } catch (const std::exception& e) {
      error = e.what();
    }
  }
  std::printf(
      "{\"libtorch\": \"%d.%d.%d\", \"cuda\": %s, \"device_count\": %d, "
      "\"device_name\": \"%s\", \"decoder\": %s, \"package\": \"%s\", "
      "\"loaded\": %s, \"package_device\": \"%s\", \"error\": \"%s\"}\n",
      TORCH_VERSION_MAJOR, TORCH_VERSION_MINOR, TORCH_VERSION_PATCH,
      cuda ? "true" : "false", count, JsonEscape(name).c_str(),
      kHasDecoder ? "true" : "false", package ? JsonEscape(package).c_str() : "",
      loaded ? "true" : "false", JsonEscape(device).c_str(), JsonEscape(error).c_str());
  std::fflush(stdout);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc >= 2 && std::strcmp(argv[1], "probe") == 0)
    return Probe(argc > 2 ? argv[2] : nullptr);
  if (argc >= 3 && std::strcmp(argv[1], "run") == 0) return Run(argc, argv);
  if (argc >= 3 && std::strcmp(argv[1], "serve") == 0) return Serve(argc, argv);
  if (argc >= 3 && std::strcmp(argv[1], "stage") == 0) return Stage(argc, argv);
  if (argc >= 2 && std::strcmp(argv[1], "frame-check") == 0) return FrameCheck();
  std::fprintf(stderr,
               "usage:\n"
               "  aoti_host probe [<program.pt2>]\n"
               "  aoti_host run <bundle_dir> [--iters N]\n"
               "  aoti_host serve <bundle_dir> [--dir d] [--repeat N] [--threads N]\n"
               "    resident loop: --dir classified batch-wise, --repeat N timed\n"
               "    passes, then one predict request per stdin line\n"
               "  aoti_host stage <bundle_dir> --dir d --out staged.raw\n"
               "    hermetic: decode into the manifest's image layout, no device\n"
               "    bundle: program.pt2 + args.txt manifest + arg<N>.raw\n"
               "  aoti_host frame-check\n"
               "    hermetic: echo serve's stdin request framing (tests)\n");
  return 2;
}
