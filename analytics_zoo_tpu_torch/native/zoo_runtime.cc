// Native host-runtime for analytics_zoo_tpu_torch (a copy of the JAX
// package's analytics_zoo_tpu/native/zoo_runtime.cc; only comments differ).
//
// TPU-native counterpart of the reference's native layer (SURVEY.md §2.2):
// where Analytics Zoo ships a PMem JNI allocator
// (zoo/src/main/java/com/intel/analytics/zoo/pmem/PersistentMemoryAllocator.java:37-43)
// and multi-threaded JVM batchers (feature/common/MTSampleToMiniBatch.scala:139),
// this library gives the Python host loop the pieces that are slow in pure
// Python: an aligned arena allocator for pinned staging buffers, a blocking
// MPMC queue for the prefetch pipeline, deterministic shuffling, row-gather
// batch assembly, and pad-to-static-shape sequence batching (XLA needs
// static shapes; ragged batches are padded+masked here, off the GIL).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <cstdio>

extern "C" {

// ---------------------------------------------------------------------------
// Arena allocator: bump allocation out of one aligned slab. Reset per epoch.
// ---------------------------------------------------------------------------

struct ZaArena {
  char* base;
  size_t capacity;
  std::atomic<size_t> offset;
};

void* za_arena_create(size_t capacity) {
  auto* a = new (std::nothrow) ZaArena();
  if (!a) return nullptr;
  // 4096 alignment: page-aligned slabs keep DMA-friendly staging buffers.
  a->base = static_cast<char*>(std::aligned_alloc(4096, capacity));
  if (!a->base) {
    delete a;
    return nullptr;
  }
  a->capacity = capacity;
  a->offset.store(0);
  return a;
}

void* za_arena_alloc(void* arena, size_t size, size_t align) {
  auto* a = static_cast<ZaArena*>(arena);
  if (align == 0) align = 64;
  size_t cur, aligned, next;
  do {
    cur = a->offset.load(std::memory_order_relaxed);
    aligned = (cur + align - 1) & ~(align - 1);
    next = aligned + size;
    if (next > a->capacity) return nullptr;
  } while (!a->offset.compare_exchange_weak(cur, next));
  return a->base + aligned;
}

size_t za_arena_used(void* arena) {
  return static_cast<ZaArena*>(arena)->offset.load();
}

size_t za_arena_capacity(void* arena) {
  return static_cast<ZaArena*>(arena)->capacity;
}

void za_arena_reset(void* arena) {
  static_cast<ZaArena*>(arena)->offset.store(0);
}

void za_arena_destroy(void* arena) {
  auto* a = static_cast<ZaArena*>(arena);
  std::free(a->base);
  delete a;
}

// ---------------------------------------------------------------------------
// Blocking MPMC queue of opaque pointers — the prefetch-pipeline backbone.
// ---------------------------------------------------------------------------

struct ZaQueue {
  std::mutex mu;
  std::condition_variable not_empty;
  std::condition_variable not_full;
  std::deque<void*> items;
  size_t capacity;
  bool closed = false;
};

void* za_queue_create(size_t capacity) {
  auto* q = new ZaQueue();
  q->capacity = capacity ? capacity : 1;
  return q;
}

// returns 1 on success, 0 if closed
int za_queue_push(void* queue, void* item, int timeout_ms) {
  auto* q = static_cast<ZaQueue*>(queue);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || q->items.size() < q->capacity; };
  if (timeout_ms < 0) {
    q->not_full.wait(lk, pred);
  } else if (!q->not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred)) {
    return 0;
  }
  if (q->closed) return 0;
  q->items.push_back(item);
  q->not_empty.notify_one();
  return 1;
}

// returns 1 on success (item in *out), 0 on timeout/closed-and-empty
int za_queue_pop(void* queue, void** out, int timeout_ms) {
  auto* q = static_cast<ZaQueue*>(queue);
  std::unique_lock<std::mutex> lk(q->mu);
  auto pred = [q] { return q->closed || !q->items.empty(); };
  if (timeout_ms < 0) {
    q->not_empty.wait(lk, pred);
  } else if (!q->not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred)) {
    return 0;
  }
  if (q->items.empty()) return 0;  // closed
  *out = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  return 1;
}

size_t za_queue_size(void* queue) {
  auto* q = static_cast<ZaQueue*>(queue);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void za_queue_close(void* queue) {
  auto* q = static_cast<ZaQueue*>(queue);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

void za_queue_destroy(void* queue) { delete static_cast<ZaQueue*>(queue); }

// ---------------------------------------------------------------------------
// Deterministic shuffle (xoshiro256**) — one call per epoch, no GIL.
// ---------------------------------------------------------------------------

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

struct Xo {
  uint64_t s[4];
  explicit Xo(uint64_t seed) {
    uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
    for (int i = 0; i < 4; ++i) {
      z ^= z >> 30;
      z *= 0xBF58476D1CE4E5B9ULL;
      z ^= z >> 27;
      z *= 0x94D049BB133111EBULL;
      z ^= z >> 31;
      s[i] = z;
      z += 0x9E3779B97F4A7C15ULL;
    }
  }
  uint64_t next() {
    uint64_t r = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
};

void za_shuffled_indices(uint64_t seed, int64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Xo rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(rng.next() % (i + 1));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// ---------------------------------------------------------------------------
// Batch assembly: gather rows by index into a contiguous batch buffer,
// multi-threaded memcpy. row_bytes = product of trailing dims * itemsize.
// ---------------------------------------------------------------------------

void za_gather_rows(const char* src, size_t row_bytes, const int64_t* idx,
                    int64_t n, char* dst, int num_threads) {
  if (num_threads <= 1 || n < 1024) {
    for (int64_t i = 0; i < n; ++i)
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    });
  }
  for (auto& th : ts) th.join();
}

// Pad ragged int32 sequences into (n, max_len) + a float32 mask.
// lengths[i] gives each row's true length; rows concatenated in `flat`.
void za_pad_sequences_i32(const int32_t* flat, const int64_t* offsets,
                          int64_t n, int64_t max_len, int32_t pad_value,
                          int32_t* out, float* mask) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = offsets[i + 1] - offsets[i];
    int64_t keep = len < max_len ? len : max_len;
    const int32_t* row = flat + offsets[i];
    for (int64_t j = 0; j < keep; ++j) {
      out[i * max_len + j] = row[j];
      if (mask) mask[i * max_len + j] = 1.0f;
    }
    for (int64_t j = keep; j < max_len; ++j) {
      out[i * max_len + j] = pad_value;
      if (mask) mask[i * max_len + j] = 0.0f;
    }
  }
}

// Cast float32 -> bfloat16 (round-to-nearest-even) for HBM-bound staging.
void za_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], 4);
    uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
    dst[i] = static_cast<uint16_t>((bits + rounding) >> 16);
  }
}

const char* za_version() { return "analytics-zoo-tpu-native/1.0"; }

}  // extern "C"
