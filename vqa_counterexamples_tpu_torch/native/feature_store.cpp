// Native feature-store runtime: mmap-backed row gather with a thread pool
// and an async prefetch queue (this package's own copy of the JAX
// package's native/feature_store.cpp, same C ABI, version 2).
//
// Role: the att-map stores (14 x 14 x 2048 rows, far beyond the card's
// memory for COCO) stay on disk, and the training loader gathers each
// batch's rows on the host (data/vqa_dataset.py) with:
//
//   * zero-copy mmap of the raw row-major matrix (no np.array load-up);
//   * parallel row gather into caller-provided (pinned) staging buffers
//     (memory-bandwidth bound; threads cover the page-fault latency);
//   * an async prefetch queue so the next batch's gather overlaps with
//     the card's work on the current one (double buffering).
//
// C ABI (ctypes-friendly), no Python.h dependency:
//   fs_abi_version()                    -> 2 (bindings refuse a mismatch)
//   fs_open(path, rows, cols, header_bytes, elem_size, n_threads)
//                                       -> handle (int64) or <0 on error;
//                                          elem_size in bytes (4 = f32,
//                                          2 = bf16 - rows are opaque bytes)
//   fs_rows/fs_cols(handle)             -> dims
//   fs_gather(handle, idx, n, out)      -> synchronous gather, 0 on success
//   fs_prefetch(handle, idx, n, out)    -> ticket (async gather into out)
//   fs_wait(handle, ticket)             -> block until that gather is done
//   fs_close(handle)
//
// Built by data/native_store.py with g++ (-O3 -shared -fPIC -pthread) into
// vqa_counterexamples_tpu_torch/_build/ at first use.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(size_t n) : stop_(false) {
    for (size_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop_front();
          }
          job();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &w : workers_) w.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      jobs_.push_back(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::deque<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

struct Ticket {
  std::atomic<int> pending{0};
  std::mutex mu;
  std::condition_variable cv;
};

struct Store {
  const char *data = nullptr;
  const void *map_base = nullptr;
  size_t map_bytes = 0;
  int fd = -1;
  int64_t rows = 0;
  int64_t cols = 0;
  int64_t elem_size = sizeof(float);
  int64_t n_threads = 1;
  std::unique_ptr<ThreadPool> pool;
  std::mutex tickets_mu;
  std::map<int64_t, std::shared_ptr<Ticket>> tickets;
  int64_t next_ticket = 1;
};

std::mutex g_stores_mu;
std::map<int64_t, std::unique_ptr<Store>> g_stores;
int64_t g_next_handle = 1;

Store *get_store(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_stores_mu);
  auto it = g_stores.find(handle);
  return it == g_stores.end() ? nullptr : it->second.get();
}

// Gather a contiguous range of output rows; each job handles a slab so the
// per-job overhead amortizes and rows stream sequentially per thread.
void gather_range(const Store *s, const int64_t *idx, int64_t begin,
                  int64_t end, char *out) {
  const size_t row_bytes =
      static_cast<size_t>(s->cols) * static_cast<size_t>(s->elem_size);
  for (int64_t i = begin; i < end; ++i) {
    const int64_t row = idx[i];
    if (row < 0 || row >= s->rows) {
      std::memset(out + i * row_bytes, 0, row_bytes);
    } else {
      std::memcpy(out + i * row_bytes, s->data + row * row_bytes, row_bytes);
    }
  }
}

// Jobs for a gather of n rows: each at least kMinJobBytes (and a row),
// at most one a pool thread.  A slab of >= 64 rows, as the JAX package's
// copy splits, gives a B 128 batch of 14 x 14 x 2048 f32 maps (802 KB a
// row) two jobs, and two threads copy 103 MB each.
constexpr int64_t kMinJobBytes = int64_t(1) << 20;

int64_t n_jobs_for(const Store *s, int64_t n) {
  const int64_t row_bytes = s->cols * s->elem_size;
  const int64_t rows_per_job =
      std::max<int64_t>(1, kMinJobBytes / std::max<int64_t>(1, row_bytes));
  return std::min<int64_t>(s->n_threads,
                           std::max<int64_t>(1, n / rows_per_job));
}

}  // namespace

extern "C" {

int32_t fs_abi_version() { return 2; }

int64_t fs_open(const char *path, int64_t rows, int64_t cols,
                int64_t header_bytes, int32_t elem_size,
                int32_t n_threads) {
  if (elem_size <= 0) elem_size = static_cast<int32_t>(sizeof(float));
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -2;
  }
  const size_t need =
      static_cast<size_t>(header_bytes) +
      static_cast<size_t>(rows) * static_cast<size_t>(cols) *
          static_cast<size_t>(elem_size);
  if (static_cast<size_t>(st.st_size) < need) {
    ::close(fd);
    return -3;
  }
  void *map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return -4;
  }
  madvise(map, st.st_size, MADV_WILLNEED);

  auto store = std::make_unique<Store>();
  store->fd = fd;
  store->map_base = map;
  store->map_bytes = st.st_size;
  store->data = static_cast<const char *>(map) + header_bytes;
  store->rows = rows;
  store->cols = cols;
  store->elem_size = elem_size;
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  store->n_threads = n_threads;
  store->pool = std::make_unique<ThreadPool>(n_threads);

  std::lock_guard<std::mutex> lock(g_stores_mu);
  const int64_t handle = g_next_handle++;
  g_stores[handle] = std::move(store);
  return handle;
}

int64_t fs_rows(int64_t handle) {
  Store *s = get_store(handle);
  return s ? s->rows : -1;
}

int64_t fs_cols(int64_t handle) {
  Store *s = get_store(handle);
  return s ? s->cols : -1;
}

int32_t fs_gather(int64_t handle, const int64_t *idx, int64_t n,
                  void *out_buf) {
  char *out = static_cast<char *>(out_buf);
  Store *s = get_store(handle);
  if (!s) return -1;
  const int64_t n_jobs = n_jobs_for(s, n);
  if (n_jobs <= 1) {
    gather_range(s, idx, 0, n, out);
    return 0;
  }
  std::atomic<int> pending(static_cast<int>(n_jobs));
  std::mutex mu;
  std::condition_variable cv;
  const int64_t step = (n + n_jobs - 1) / n_jobs;
  for (int64_t j = 0; j < n_jobs; ++j) {
    const int64_t begin = j * step;
    const int64_t end = std::min(n, begin + step);
    s->pool->submit([=, &pending, &mu, &cv] {
      gather_range(s, idx, begin, end, out);
      if (pending.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lock(mu);
  cv.wait(lock, [&] { return pending.load() == 0; });
  return 0;
}

int64_t fs_prefetch(int64_t handle, const int64_t *idx, int64_t n,
                    void *out_buf) {
  char *out = static_cast<char *>(out_buf);
  Store *s = get_store(handle);
  if (!s) return -1;
  auto ticket = std::make_shared<Ticket>();
  int64_t ticket_id;
  {
    std::lock_guard<std::mutex> lock(s->tickets_mu);
    ticket_id = s->next_ticket++;
    s->tickets[ticket_id] = ticket;
  }
  // copy the indices: the caller's buffer may be reused immediately
  auto indices = std::make_shared<std::vector<int64_t>>(idx, idx + n);
  const int64_t n_jobs = n_jobs_for(s, n);
  ticket->pending.store(static_cast<int>(n_jobs));
  const int64_t step = (n + n_jobs - 1) / n_jobs;
  for (int64_t j = 0; j < n_jobs; ++j) {
    const int64_t begin = j * step;
    const int64_t end = std::min(n, begin + step);
    s->pool->submit([=] {
      gather_range(s, indices->data(), begin, end, out);
      if (ticket->pending.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(ticket->mu);
        ticket->cv.notify_all();
      }
    });
  }
  return ticket_id;
}

int32_t fs_wait(int64_t handle, int64_t ticket_id) {
  Store *s = get_store(handle);
  if (!s) return -1;
  std::shared_ptr<Ticket> ticket;
  {
    std::lock_guard<std::mutex> lock(s->tickets_mu);
    auto it = s->tickets.find(ticket_id);
    if (it == s->tickets.end()) return -2;
    ticket = it->second;
  }
  {
    std::unique_lock<std::mutex> lock(ticket->mu);
    ticket->cv.wait(lock, [&] { return ticket->pending.load() == 0; });
  }
  std::lock_guard<std::mutex> lock(s->tickets_mu);
  s->tickets.erase(ticket_id);
  return 0;
}

int32_t fs_close(int64_t handle) {
  std::unique_ptr<Store> store;
  {
    std::lock_guard<std::mutex> lock(g_stores_mu);
    auto it = g_stores.find(handle);
    if (it == g_stores.end()) return -1;
    store = std::move(it->second);
    g_stores.erase(it);
  }
  store->pool.reset();  // drain workers before unmapping
  munmap(const_cast<void *>(store->map_base), store->map_bytes);
  ::close(store->fd);
  return 0;
}

}  // extern "C"
