// Lock-free single-producer/single-consumer audio ring buffer.
//
// Native runtime piece for the streaming pipeline: the audio-capture thread
// (PortAudio callback or any device thread) pushes fixed-size sample chunks
// while the Python/JAX inference loop pops analysis hops — replacing the
// reference's unguarded Python list ring (realtime_inference.py:131-139)
// with a bounded, wait-free structure suitable for a real-time audio thread.
//
// C ABI for ctypes (alivevc_tpu/native_bindings.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct RingBuffer {
  float* data;
  int64_t capacity;                 // samples, power of two
  std::atomic<int64_t> head;        // write position (producer)
  std::atomic<int64_t> tail;        // read position (consumer)
  std::atomic<int64_t> overruns;
};

int64_t next_pow2(int64_t v) {
  int64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* alive_ring_create(int64_t capacity_samples) {
  auto* rb = new (std::nothrow) RingBuffer();
  if (!rb) return nullptr;
  rb->capacity = next_pow2(capacity_samples);
  rb->data = new (std::nothrow) float[rb->capacity];
  if (!rb->data) {
    delete rb;
    return nullptr;
  }
  rb->head.store(0);
  rb->tail.store(0);
  rb->overruns.store(0);
  return rb;
}

void alive_ring_destroy(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  if (!rb) return;
  delete[] rb->data;
  delete rb;
}

int64_t alive_ring_size(void* p) {
  auto* rb = static_cast<RingBuffer*>(p);
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

// Producer: push up to n samples; returns the count actually stored.  On
// overflow the *newest* samples are dropped (never writes past
// tail+capacity), so a consumer concurrently inside alive_ring_pop can
// never have the region it is copying overwritten — the SPSC invariant a
// real-time capture thread needs.  Overrun samples are counted; capture
// must never block.
int64_t alive_ring_push(void* p, const float* samples, int64_t n) {
  auto* rb = static_cast<RingBuffer*>(p);
  const int64_t head = rb->head.load(std::memory_order_relaxed);
  const int64_t tail = rb->tail.load(std::memory_order_acquire);
  const int64_t free_space = rb->capacity - (head - tail);
  const int64_t to_write = n <= free_space ? n : free_space;
  if (n > to_write) {
    rb->overruns.fetch_add(n - to_write, std::memory_order_relaxed);
  }
  const int64_t mask = rb->capacity - 1;
  for (int64_t i = 0; i < to_write; ++i) rb->data[(head + i) & mask] = samples[i];
  rb->head.store(head + to_write, std::memory_order_release);
  return to_write;
}

// Consumer: pop exactly n samples into out.  Returns n on success, 0 if not
// enough data is buffered (non-blocking).
int64_t alive_ring_pop(void* p, float* out, int64_t n) {
  auto* rb = static_cast<RingBuffer*>(p);
  const int64_t tail = rb->tail.load(std::memory_order_relaxed);
  const int64_t head = rb->head.load(std::memory_order_acquire);
  if (head - tail < n) return 0;
  const int64_t mask = rb->capacity - 1;
  for (int64_t i = 0; i < n; ++i) out[i] = rb->data[(tail + i) & mask];
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

int64_t alive_ring_overruns(void* p) {
  return static_cast<RingBuffer*>(p)->overruns.load(std::memory_order_relaxed);
}

}  // extern "C"
