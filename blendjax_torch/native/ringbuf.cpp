// blendjax_torch native transport: SPSC shared-memory byte ring, the
// port's own copy of blendjax/native/ringbuf.cpp with the same record
// layout byte for byte (either package's writer feeds the other's reader).
//
// Same-host Blender->consumer frame transport that bypasses the tcp
// loopback path (ZMQ frame copy -> kernel send -> kernel recv -> consumer
// copy) with a single producer-side memcpy into a POSIX shm arena the
// consumer reads in place.
//
// Layout:  [Header | byte arena]
// Records: u64 length, payload, padded to 8 bytes.  A length of
// UINT64_MAX is a wrap marker: the reader skips to the arena start.
// Single producer / single consumer, lock-free (acquire/release atomics),
// bounded: a full ring blocks the producer (same backpressure contract as
// the ZMQ HWM path, publisher.py).
//
// C ABI for ctypes; no exceptions cross the boundary.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x424a5852494e4701ULL;  // "BJXRING" v1
constexpr uint64_t kWrapMarker = ~0ULL;

struct Header {
  // magic is the header's publication flag: bjr_create stores it with
  // release ordering AFTER every other field is initialized, and
  // bjr_open's spin loads it with acquire — otherwise a reader could
  // observe magic == kMagic while capacity is still 0 (then compute
  // `pos % 0`, SIGFPE) on a compiler/arch that reorders the plain stores.
  std::atomic<uint64_t> magic;
  uint64_t capacity;                  // arena size in bytes (multiple of 8)
  std::atomic<uint64_t> head;         // producer: total bytes written
  std::atomic<uint64_t> tail;         // consumer: total bytes consumed
  std::atomic<uint32_t> producer_closed;
  uint32_t _pad;
};

struct Handle {
  Header* hdr;
  uint8_t* arena;
  uint64_t map_size;
  char name[256];
  int owner;          // created (vs opened)
  uint64_t last_rec;  // bytes to release after read_acquire
  uint64_t next_vanish_check_ms;  // rate-limits bjr_vanished's syscalls
                                  // across timeout-0 polls (hot rotation)
  dev_t st_dev;       // identity of the mapped shm object: a respawned
  ino_t st_ino;       // producer's bjr_create makes a NEW object under the
                      // same name; the reader detects the inode change
};

inline uint64_t pad8(uint64_t n) { return (n + 7) & ~7ULL; }

inline void sleep_us(unsigned us) {
  struct timespec ts = {0, static_cast<long>(us) * 1000L};
  nanosleep(&ts, nullptr);
}

inline uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000ULL + ts.tv_nsec / 1000000ULL;
}

}  // namespace

extern "C" {

// Create a ring (producer side).  capacity is rounded up to 8.
// Returns nullptr on failure.
void* bjr_create(const char* name, uint64_t capacity) {
  capacity = pad8(capacity);
  shm_unlink(name);  // stale ring from a crashed producer
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t map_size = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  struct stat id_st;
  fstat(fd, &id_st);
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) Header();
  hdr->capacity = capacity;
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->producer_closed.store(0, std::memory_order_relaxed);
  hdr->magic.store(kMagic, std::memory_order_release);  // published last

  auto* h = new Handle();
  h->hdr = hdr;
  h->arena = reinterpret_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_size = map_size;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 1;
  h->last_rec = 0;
  h->st_dev = id_st.st_dev;
  h->st_ino = id_st.st_ino;
  return h;
}

// Open an existing ring (consumer side).  Waits up to timeout_ms for the
// producer to create it.  Returns nullptr on failure/timeout.
void* bjr_open(const char* name, int timeout_ms) {
  uint64_t deadline = now_ms() + static_cast<uint64_t>(timeout_ms < 0 ? 0 : timeout_ms);
  int fd = -1;
  for (;;) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    if (timeout_ms >= 0 && now_ms() >= deadline) return nullptr;
    sleep_us(200);
  }
  struct stat st;
  while (fstat(fd, &st) == 0 &&
         st.st_size < static_cast<off_t>(sizeof(Header))) {
    if (timeout_ms >= 0 && now_ms() >= deadline) {
      close(fd);
      return nullptr;
    }
    sleep_us(200);
  }
  uint64_t map_size = static_cast<uint64_t>(st.st_size);
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = reinterpret_cast<Header*>(mem);
  // acquire pairs with bjr_create's release store: capacity et al. are
  // fully visible once magic reads kMagic
  while (hdr->magic.load(std::memory_order_acquire) != kMagic) {
    if (timeout_ms >= 0 && now_ms() >= deadline) {
      munmap(mem, map_size);
      return nullptr;
    }
    sleep_us(200);
  }
  auto* h = new Handle();
  h->hdr = hdr;
  h->arena = reinterpret_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_size = map_size;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 0;
  h->last_rec = 0;
  h->st_dev = st.st_dev;
  h->st_ino = st.st_ino;
  return h;
}

// 0: the mapped object is still what `name` resolves to.
// 1: `name` resolves to a DIFFERENT object (producer respawned, bjr_create
//    unlinked + recreated) or no longer exists (crashed, not yet back).
int bjr_vanished(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  int fd = shm_open(h->name, O_RDONLY, 0600);
  if (fd < 0) return 1;
  struct stat st;
  int ok = fstat(fd, &st) == 0 && st.st_dev == h->st_dev &&
           st.st_ino == h->st_ino;
  close(fd);
  return ok ? 0 : 1;
}

namespace {

// Claim `need` contiguous bytes (record payload + 8-byte length prefix
// already included by the caller).  Returns the write position, or
// UINT64_MAX on timeout.  Handles the wrap marker.
uint64_t claim(Handle* h, uint64_t need, int timeout_ms) {
  Header* hdr = h->hdr;
  const uint64_t cap = hdr->capacity;
  uint64_t deadline = now_ms() + static_cast<uint64_t>(timeout_ms < 0 ? 0 : timeout_ms);
  uint64_t head = hdr->head.load(std::memory_order_relaxed);
  for (;;) {
    uint64_t tail = hdr->tail.load(std::memory_order_acquire);
    uint64_t pos = head % cap;
    uint64_t to_end = cap - pos;
    uint64_t total = (to_end < need) ? to_end + need : need;
    if (cap - (head - tail) >= total) {
      if (to_end < need) {
        std::memcpy(h->arena + pos, &kWrapMarker, 8);
        head += to_end;
        hdr->head.store(head, std::memory_order_release);
        pos = 0;
      }
      return pos;
    }
    if (timeout_ms >= 0 && now_ms() >= deadline) return ~0ULL;
    sleep_us(100);
  }
}

}  // namespace

// Scatter-gather write: one framed record assembled directly in the ring
// (no caller-side join).  Record payload layout:
//   u32 nframes | u64 len[nframes] | frame bytes (concatenated)
// This is the hot path for the Python bindings: numpy frame payloads are
// memcpy'd exactly once, from their own buffers into shm, with the GIL
// released (ctypes foreign call).
int bjr_write_v(void* handle, const void* const* bufs, const uint64_t* lens,
                uint32_t nbufs, int timeout_ms) {
  auto* h = static_cast<Handle*>(handle);
  const uint64_t cap = h->hdr->capacity;
  uint64_t payload = 4 + 8ULL * nbufs;
  for (uint32_t i = 0; i < nbufs; ++i) payload += lens[i];
  const uint64_t need = 8 + pad8(payload);
  if (need + 8 > cap) return -2;
  uint64_t pos = claim(h, need, timeout_ms);
  if (pos == ~0ULL) return -1;
  uint8_t* p = h->arena + pos;
  std::memcpy(p, &payload, 8);
  p += 8;
  std::memcpy(p, &nbufs, 4);
  p += 4;
  std::memcpy(p, lens, 8ULL * nbufs);
  p += 8ULL * nbufs;
  for (uint32_t i = 0; i < nbufs; ++i) {
    std::memcpy(p, bufs[i], lens[i]);
    p += lens[i];
  }
  h->hdr->head.fetch_add(need, std::memory_order_release);
  return 0;
}

// Acquire the next record without copying.  *data points into the shm
// arena and stays valid until bjr_read_release.  Returns 0 ok, -1 timeout,
// -3 producer closed and ring drained, -4 ring vanished/recreated under
// this mapping (producer crashed or was respawned; reopen to continue).
// Buffered records are always drained before -4 is reported — a crash
// mid-write is invisible (head only advances after a complete record).
int bjr_read_acquire(void* handle, const void** data, uint64_t* len,
                     int timeout_ms) {
  auto* h = static_cast<Handle*>(handle);
  Header* hdr = h->hdr;
  const uint64_t cap = hdr->capacity;
  uint64_t deadline = now_ms() + static_cast<uint64_t>(timeout_ms < 0 ? 0 : timeout_ms);
  uint64_t next_vanish_check = now_ms() + 50;

  for (;;) {
    uint64_t tail = hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = hdr->head.load(std::memory_order_acquire);
    if (head != tail) {
      uint64_t pos = tail % cap;
      uint64_t rec_len;
      std::memcpy(&rec_len, h->arena + pos, 8);
      if (rec_len == kWrapMarker) {
        hdr->tail.store(tail + (cap - pos), std::memory_order_release);
        continue;
      }
      *data = h->arena + pos + 8;
      *len = rec_len;
      h->last_rec = 8 + pad8(rec_len);
      return 0;
    }
    if (hdr->producer_closed.load(std::memory_order_acquire)) return -3;
    if (timeout_ms >= 0 && now_ms() >= deadline) {
      // Vanish must be detectable even at timeout_ms == 0: the multi-ring
      // rotation polls with 0 and would otherwise never learn that a
      // respawned producer recreated the ring (stale mapping polled
      // forever, returning -1 until the dataset times out).  The check is
      // rate-limited via the handle (~50 ms cadence) so steady-state idle
      // polls don't pay shm_open+fstat per call; healing latency stays
      // bounded at the cadence.
      if (!h->owner && now_ms() >= h->next_vanish_check_ms) {
        h->next_vanish_check_ms = now_ms() + 50;
        if (bjr_vanished(handle)) return -4;
      }
      return -1;
    }
    if (!h->owner && now_ms() >= next_vanish_check) {
      if (bjr_vanished(handle)) return -4;
      next_vanish_check = now_ms() + 50;
    }
    sleep_us(100);
  }
}

void bjr_read_release(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (h->last_rec) {
    h->hdr->tail.fetch_add(h->last_rec, std::memory_order_release);
    h->last_rec = 0;
  }
}

// Number of unread bytes currently buffered (diagnostics).
uint64_t bjr_pending(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h->hdr->head.load(std::memory_order_acquire) -
         h->hdr->tail.load(std::memory_order_acquire);
}

void bjr_close(void* handle, int unlink_shm) {
  auto* h = static_cast<Handle*>(handle);
  if (h->owner) h->hdr->producer_closed.store(1, std::memory_order_release);
  munmap(reinterpret_cast<void*>(h->hdr), h->map_size);
  if (unlink_shm) shm_unlink(h->name);
  delete h;
}

// Batch assembly: copy n equal-role source buffers back-to-back into dst.
// ctypes releases the GIL for the duration of the call, so concurrent
// loader workers collate truly in parallel (np.stack holds the GIL for the
// whole copy, serializing every worker thread through one core).
void bjr_gather(char* dst, const void* const* srcs, const uint64_t* lens,
                uint64_t n) {
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; ++i) {
    memcpy(dst + off, srcs[i], lens[i]);
    off += lens[i];
  }
}

}  // extern "C"
