// Native JPEG decode + resize + center-crop pipeline for feature extraction
// and serving: the PyTorch package's own copy of the JAX package's
// native/image_decoder.cpp, same arithmetic and ABI (replaces the
// reference's PIL-in-worker-processes image path: reference
// vqa/datasets/images.py:23-24 decode, vqa/datasets/coco.py:84-92
// Scale->CenterCrop transform, vqa/lib/dataloader.py:126-155
// multiprocessing workers).
//
// Why native: Python threads cannot scale JPEG decode (PIL holds the GIL
// through most of decode/resize), and multiprocessing pays a 600 KB/image
// IPC copy.  This library decodes with libjpeg and resamples with a
// bit-exact reimplementation of Pillow's fixed-point bilinear resampling
// (triangle filter, PRECISION_BITS fixed point, uint8 intermediate between
// the horizontal and vertical passes), so the output matches
// models/convnets.preprocess_image_uint8 exactly while running GIL-free on
// a C++ thread pool.  data/native_decoder.py builds it with g++ at first
// use (no -march=native: the build host and the run host may differ).
//
// ABI (ctypes, see data/native_decoder.py):
//   id_abi_version() -> 2
//   id_decode_files(paths, n, n_threads, size, out, ok)     files on disk
//   id_decode_buffers(bufs, lens, n, n_threads, size, out, ok)  in-memory
// out: (n, size, size, 3) uint8, C-order.  ok[i]=1 on success, 0 on any
// per-item failure (unsupported color space, corrupt file) — the Python
// wrapper falls back to PIL for those items only.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

extern "C" {

int32_t id_abi_version() { return 2; }

}  // extern "C" (reopened below for the entry points)

namespace {

// ---------------------------------------------------------------------------
// Pillow-compatible bilinear resampling (8 bits per channel fixed point).
// Mirrors Pillow src/libImaging/Resample.c: precompute_coeffs +
// normalize_coeffs_8bpc + ResampleHorizontal/Vertical_8bpc with the
// triangle (bilinear) filter.  Kept arithmetic-identical so the parity test
// against PIL can assert exact equality.
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (255 << kPrecisionBits)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Coefficient table for one axis: bounds[out*2] = {xmin, xmax}, fixed-point
// weights kk[out * ksize].
struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;
  std::vector<int32_t> kk;
};

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1.0
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(static_cast<size_t>(out_size) * 2);
  std::vector<double> prekk(static_cast<size_t>(out_size) * c.ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * c.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; x++) {
      const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; x++) k[x] /= ww;
    c.bounds[static_cast<size_t>(xx) * 2 + 0] = xmin;
    c.bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
  }
  c.kk.resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); i++) {
    // Pillow normalize_coeffs_8bpc rounding
    c.kk[i] = prekk[i] < 0
                  ? static_cast<int32_t>(-0.5 + prekk[i] * (1 << kPrecisionBits))
                  : static_cast<int32_t>(0.5 + prekk[i] * (1 << kPrecisionBits));
  }
  return c;
}

// Horizontal pass: (h, in_w, ch) -> (h, out_w, ch), uint8 in/out.
void resample_horizontal(const uint8_t* in, int h, int in_w, int ch,
                         uint8_t* out, int out_w, const Coeffs& c) {
  for (int yy = 0; yy < h; yy++) {
    const uint8_t* row = in + static_cast<size_t>(yy) * in_w * ch;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * ch;
    for (int xx = 0; xx < out_w; xx++) {
      const int xmin = c.bounds[static_cast<size_t>(xx) * 2 + 0];
      const int xmax = c.bounds[static_cast<size_t>(xx) * 2 + 1];
      const int32_t* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      for (int d = 0; d < ch; d++) {
        int ss0 = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; x++)
          ss0 += row[(x + xmin) * ch + d] * k[x];
        orow[xx * ch + d] = clip8(ss0);
      }
    }
  }
}

// Vertical pass: (in_h, w, ch) -> (out_h, w, ch), uint8 in/out.
void resample_vertical(const uint8_t* in, int w, int ch, uint8_t* out,
                       int out_h, const Coeffs& c) {
  for (int yy = 0; yy < out_h; yy++) {
    const int ymin = c.bounds[static_cast<size_t>(yy) * 2 + 0];
    const int ymax = c.bounds[static_cast<size_t>(yy) * 2 + 1];
    const int32_t* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * ch;
    for (int xx = 0; xx < w * ch; xx++) {
      int ss0 = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++)
        ss0 += in[static_cast<size_t>(y + ymin) * w * ch + xx] * k[y];
      orow[xx] = clip8(ss0);
    }
  }
}

// ---------------------------------------------------------------------------
// libjpeg decode with longjmp error recovery.
// ---------------------------------------------------------------------------

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// silence stderr but keep counting warnings (the stock emit_message does
// the counting; replacing it without the increment would hide truncation)
void jpeg_silent(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) cinfo->err->num_warnings++;
}

// Decode a JPEG byte buffer into interleaved uint8; grayscale stays 1
// channel (resampled single-channel, expanded at the end — matches PIL
// convert("RGB") after mode-L resize numerically because the conversion is
// a pure channel replication).  Returns false on error/unsupported space.
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* pixels,
                 int* width, int* height, int* channels) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.emit_message = jpeg_silent;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else if (cinfo.jpeg_color_space == JCS_YCbCr ||
             cinfo.jpeg_color_space == JCS_RGB) {
    cinfo.out_color_space = JCS_RGB;
  } else {
    // CMYK/YCCK etc: punt to the PIL fallback
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  const int ch = cinfo.output_components;
  // reject absurd header dimensions (a crafted 65k x 65k header would
  // otherwise attempt a ~12 GB allocation and abort the worker thread)
  constexpr int64_t kMaxPixels = 128LL * 1024 * 1024;
  if (w <= 0 || h <= 0 || (ch != 1 && ch != 3) ||
      static_cast<int64_t>(w) * h > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels->resize(static_cast<size_t>(w) * h * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * w * ch;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // Truncated/corrupt streams surface as libjpeg WARNINGS (premature EOF
  // fills the remainder with gray and keeps going) — PIL raises on those,
  // so treat any warning as failure rather than silently emitting a
  // half-gray image into the feature store.
  const bool clean = cinfo.err->num_warnings == 0;
  jpeg_destroy_decompress(&cinfo);
  *width = w;
  *height = h;
  *channels = ch;
  return clean;
}

// Scale (shorter side -> size, aspect kept, round-half-even like Python
// round()) + bilinear resample + CenterCrop(size) + expand gray to RGB.
// Matches models/convnets.preprocess_image_uint8.
bool process_one(const uint8_t* buf, size_t len, int size, uint8_t* out) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0, ch = 0;
  if (!decode_jpeg(buf, len, &pixels, &w, &h, &ch)) return false;

  int nw, nh;
  if (w < h) {
    nw = size;
    nh = static_cast<int>(std::nearbyint(static_cast<double>(h) * size / w));
  } else {
    nh = size;
    nw = static_cast<int>(std::nearbyint(static_cast<double>(w) * size / h));
  }
  // horizontal then vertical, uint8 intermediate (Pillow pass order)
  const Coeffs cx = precompute_coeffs(w, nw);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * nw * ch);
  resample_horizontal(pixels.data(), h, w, ch, tmp.data(), nw, cx);
  const Coeffs cy = precompute_coeffs(h, nh);
  std::vector<uint8_t> resized(static_cast<size_t>(nh) * nw * ch);
  resample_vertical(tmp.data(), nw, ch, resized.data(), nh, cy);

  const int left = (nw - size) / 2;
  const int top = (nh - size) / 2;
  for (int y = 0; y < size; y++) {
    const uint8_t* src =
        resized.data() + (static_cast<size_t>(y + top) * nw + left) * ch;
    uint8_t* dst = out + static_cast<size_t>(y) * size * 3;
    if (ch == 3) {
      std::memcpy(dst, src, static_cast<size_t>(size) * 3);
    } else {
      for (int x = 0; x < size; x++) {
        dst[x * 3 + 0] = src[x];
        dst[x * 3 + 1] = src[x];
        dst[x * 3 + 2] = src[x];
      }
    }
  }
  return true;
}

// Read a whole file; returns empty vector on failure.
std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> data;
  FILE* f = std::fopen(path, "rb");
  if (!f) return data;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz > 0) {
    data.resize(static_cast<size_t>(sz));
    if (std::fread(data.data(), 1, data.size(), f) != data.size())
      data.clear();
  }
  std::fclose(f);
  return data;
}

// Persistent process-wide worker pool: serving calls decode per request, so
// spawning/joining OS threads per call would churn (and oversubscribe under
// concurrent /batch load).  Threads start lazily on first parallel use and
// live for the process; per-call parallelism is capped by the caller's
// n_threads.
class WorkerPool {
 public:
  static WorkerPool& instance() {
    static WorkerPool pool(
        std::max(1u, std::thread::hardware_concurrency()));
    return pool;
  }

  int size() const { return n_threads_; }

  // Run fn(0..n-1) with at most `width` tasks in flight; blocks until done.
  void run(int n, int width, const std::function<void(int)>& fn) {
    std::atomic<int> next(0);
    std::atomic<int> done(0);
    std::mutex done_mu;
    std::condition_variable done_cv;
    width = std::max(1, std::min({width, n, n_threads_}));
    auto worker = [&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
      if (done.fetch_add(1) + 1 == width) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    };
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (int t = 0; t < width; t++) queue_.emplace_back(worker);
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&]() { return done.load() == width; });
  }

 private:
  explicit WorkerPool(unsigned n) : n_threads_(static_cast<int>(n)) {
    threads_.reserve(n);
    for (unsigned t = 0; t < n; t++) {
      threads_.emplace_back([this]() {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this]() { return stop_ || !queue_.empty(); });
            if (stop_ && queue_.empty()) return;
            task = std::move(queue_.front());
            queue_.pop_front();
          }
          task();
        }
      });
    }
  }

  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  const int n_threads_;
  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

template <typename Fn>
void parallel_for(int n, int n_threads, Fn fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1 || n <= 1) {
    for (int i = 0; i < n; i++) fn(i);
    return;
  }
  WorkerPool::instance().run(n, n_threads, fn);
}

}  // namespace

extern "C" {

// Decode n files into out (n, size, size, 3) uint8; ok[i]=1 on success.
// Returns the number of successes.
int32_t id_decode_files(const char** paths, int32_t n, int32_t n_threads,
                        int32_t size, uint8_t* out, int32_t* ok) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  std::atomic<int32_t> n_ok(0);
  parallel_for(n, n_threads, [&](int i) {
    const std::vector<uint8_t> data = read_file(paths[i]);
    const bool good =
        !data.empty() &&
        process_one(data.data(), data.size(), size, out + item * i);
    ok[i] = good ? 1 : 0;
    if (good) n_ok.fetch_add(1);
  });
  return n_ok.load();
}

// Same for in-memory JPEG buffers (serving: base64-decoded request bodies).
int32_t id_decode_buffers(const uint8_t** bufs, const int64_t* lens,
                          int32_t n, int32_t n_threads, int32_t size,
                          uint8_t* out, int32_t* ok) {
  const size_t item = static_cast<size_t>(size) * size * 3;
  std::atomic<int32_t> n_ok(0);
  parallel_for(n, n_threads, [&](int i) {
    const bool good =
        lens[i] > 0 &&
        process_one(bufs[i], static_cast<size_t>(lens[i]), size,
                    out + item * i);
    ok[i] = good ? 1 : 0;
    if (good) n_ok.fetch_add(1);
  });
  return n_ok.load();
}

}  // extern "C"
