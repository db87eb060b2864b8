// Threaded, prefetching batch loader over an in-memory uint8 dataset.
//
// The host half of the port's data path (grace_tpu_torch.data.NativeLoader
// binds it with ctypes): worker threads assemble normalized float32
// batches into a bounded ring while the card runs the previous step.
//
//   * Dataset: raw samples held in memory as uint8 NHWC images + int32
//     labels, registered from Python (gl_open_memory). The MNIST and
//     CIFAR-10 files are read in Python; this library reads no files.
//   * Sampler: per-epoch Fisher-Yates shuffle seeded by
//     seed * 0x9E3779B97F4A7C15 + epoch (std::mt19937_64) — deterministic
//     and identical on every process — then rank r takes the strided slice
//     r::world, so the ranks partition each epoch disjointly.
//   * Pipeline: N worker threads claim batch indices from an atomic
//     counter and normalize ((x - mean·255) / (std·255), the float32 op
//     order of MemoryDataset.normalize, so the values are bit-identical;
//     one channel loop a sample, which the compiler vectorises) into
//     preallocated slots of a ring of queue_depth batches; the caller
//     takes slots in batch order. Backpressure by condition variables.
//   * A short final batch (drop_last = 0) wraps to the front of itself so
//     every batch has the same shape.
//
// C ABI (for ctypes). gl_last_error() describes the most recent failure of
// the calling thread.
//
// Build: c++ -O3 -std=c++17 -fPIC -pthread -shared dataloader.cpp -o lib.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct Dataset {
  std::vector<uint8_t> images;  // n * h * w * c, NHWC
  std::vector<int32_t> labels;  // n
  int64_t n = 0, h = 0, w = 0, c = 0;
  float mean[3] = {0, 0, 0};
  float stddiv[3] = {255, 255, 255};

  int64_t sample_size() const { return h * w * c; }
};

struct Slot {
  std::vector<float> x;
  std::vector<int32_t> y;
  int64_t batch_idx = -1;  // -1 free, -2 claimed, >= 0 the batch it holds
  bool ready = false;
};

struct Loader {
  Dataset ds;
  int64_t batch = 0;
  int64_t rank = 0, world = 1;
  uint64_t seed = 0;
  bool shuffle = true;
  bool drop_last = true;

  // epoch state
  std::vector<int64_t> order;  // this rank's sample order for the epoch
  int64_t batches_per_epoch = 0;

  // pipeline
  std::vector<std::thread> workers;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int64_t> next_claim{0};
  int64_t next_serve = 0;
  bool stopping = false;

  ~Loader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> l(mu);
      stopping = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    workers.clear();
  }

  void build_epoch(int64_t e) {
    std::vector<int64_t> perm(ds.n);
    for (int64_t i = 0; i < ds.n; ++i) perm[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + uint64_t(e));
      for (int64_t i = ds.n - 1; i > 0; --i) {
        std::uniform_int_distribution<int64_t> d(0, i);
        std::swap(perm[i], perm[d(rng)]);
      }
    }
    order.clear();
    for (int64_t i = rank; i < ds.n; i += world) order.push_back(perm[i]);
    const int64_t local = (int64_t)order.size();
    batches_per_epoch =
        drop_last ? local / batch : (local + batch - 1) / batch;
  }

  // One sample: a division, not a reciprocal multiply, as numpy divides
  // (IEEE-exact, so the vectorised loop gives the same bits).
  static void normalize(const uint8_t* __restrict img, float* __restrict out,
                        int64_t pixels, int64_t c, const float* mean,
                        const float* stddiv) {
    if (c == 1) {
      const float m = mean[0], d = stddiv[0];
      for (int64_t p = 0; p < pixels; ++p) out[p] = (float(img[p]) - m) / d;
      return;
    }
    for (int64_t p = 0; p < pixels; ++p)
      for (int64_t ch = 0; ch < c; ++ch)
        out[p * c + ch] = (float(img[p * c + ch]) - mean[ch]) / stddiv[ch];
  }

  void fill(Slot* s, int64_t b) {
    const int64_t ss = ds.sample_size();
    const int64_t start = b * batch;
    const int64_t count =
        std::min<int64_t>(batch, (int64_t)order.size() - start);
    s->x.resize(batch * ss);
    s->y.resize(batch);
    for (int64_t j = 0; j < batch; ++j) {
      const int64_t src = order[start + (j % std::max<int64_t>(count, 1))];
      normalize(ds.images.data() + src * ss, s->x.data() + j * ss,
                ds.h * ds.w, ds.c, ds.mean, ds.stddiv);
      s->y[j] = ds.labels[src];
    }
    s->batch_idx = b;
  }

  void worker() {
    for (;;) {
      // Take a slot first, then claim the next batch index: claiming
      // first could leave the worker that owns next_serve waiting for a
      // slot that only the consumer of next_serve would free. Claiming
      // after taking a slot bounds outstanding claims to the slot count.
      Slot* slot = nullptr;
      {
        std::unique_lock<std::mutex> l(mu);
        for (;;) {
          if (stopping) return;
          if (next_claim.load() >= batches_per_epoch) return;
          for (auto& s : slots) {
            if (!s.ready && s.batch_idx == -1) {
              s.batch_idx = -2;
              slot = &s;
              break;
            }
          }
          if (slot) break;
          cv_free.wait(l);
        }
      }
      const int64_t b = next_claim.fetch_add(1);
      if (b >= batches_per_epoch) {
        std::lock_guard<std::mutex> l(mu);
        slot->batch_idx = -1;
        cv_free.notify_all();
        return;
      }
      fill(slot, b);
      {
        std::lock_guard<std::mutex> l(mu);
        slot->ready = true;
      }
      cv_ready.notify_all();
    }
  }

  void start_epoch(int64_t e, int64_t n_threads, int64_t queue_depth) {
    stop();
    {
      std::lock_guard<std::mutex> l(mu);
      stopping = false;
    }
    build_epoch(e);
    next_claim = 0;
    next_serve = 0;
    slots.assign(std::max<int64_t>(queue_depth, 2), Slot{});
    for (int64_t i = 0; i < std::max<int64_t>(n_threads, 1); ++i)
      workers.emplace_back([this] { worker(); });
  }

  // 1 with (x, y) filled, 0 at the end of the epoch, -1 if stopped.
  int next(float* x, int32_t* y) {
    if (next_serve >= batches_per_epoch) return 0;
    Slot* slot = nullptr;
    {
      std::unique_lock<std::mutex> l(mu);
      for (;;) {
        if (stopping) return -1;
        for (auto& s : slots) {
          if (s.ready && s.batch_idx == next_serve) {
            slot = &s;
            break;
          }
        }
        if (slot) break;
        cv_ready.wait(l);
      }
    }
    std::memcpy(x, slot->x.data(), slot->x.size() * sizeof(float));
    std::memcpy(y, slot->y.data(), slot->y.size() * sizeof(int32_t));
    {
      std::lock_guard<std::mutex> l(mu);
      slot->ready = false;
      slot->batch_idx = -1;
      ++next_serve;
    }
    cv_free.notify_all();
    return 1;
  }
};

}  // namespace

extern "C" {

const char* gl_last_error() { return g_error.c_str(); }

// Copies an in-memory uint8 NHWC dataset (c <= 3 channels); mean and stdv
// are per-channel in [0, 1] units, or null for x / 255.
void* gl_open_memory(const uint8_t* images, const int32_t* labels, int64_t n,
                     int64_t h, int64_t w, int64_t c, const float* mean,
                     const float* stdv, int64_t batch, int shuffle,
                     int drop_last, uint64_t seed, int64_t rank,
                     int64_t world) {
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || c > 3 || batch <= 0 ||
      world <= 0 || rank < 0 || rank >= world) {
    set_error("gl_open_memory: bad shape, batch, rank or world");
    return nullptr;
  }
  auto* ld = new Loader();
  Dataset& ds = ld->ds;
  ds.n = n;
  ds.h = h;
  ds.w = w;
  ds.c = c;
  ds.images.assign(images, images + n * h * w * c);
  ds.labels.assign(labels, labels + n);
  for (int i = 0; i < 3; ++i) {
    ds.mean[i] = mean ? mean[i] * 255.0f : 0.0f;
    ds.stddiv[i] = stdv ? stdv[i] * 255.0f : 255.0f;
  }
  ld->batch = batch;
  ld->shuffle = shuffle != 0;
  ld->drop_last = drop_last != 0;
  ld->seed = seed;
  ld->rank = rank;
  ld->world = world;
  return ld;
}

int64_t gl_start_epoch(void* h, int64_t epoch, int64_t n_threads,
                       int64_t queue_depth) {
  auto* ld = static_cast<Loader*>(h);
  ld->start_epoch(epoch, n_threads, queue_depth);
  return ld->batches_per_epoch;
}

int gl_next(void* h, float* x, int32_t* y) {
  return static_cast<Loader*>(h)->next(x, y);
}

void gl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
