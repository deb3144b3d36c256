// ThreadSanitizer stress for the port's SPSC shm ring (ringbuf.cpp); the
// port of blendjax/native/tsan_stress.cpp.
//
// TSAN keys its shadow state on VIRTUAL addresses, so a reader that
// mmap()s the shm object separately (as a real cross-process consumer
// does) is invisible to the tool: every cross-thread pair would go
// unchecked and the harness would pass vacuously.  The reader here runs
// through an ALIAS of the writer's own Handle (one address range, both
// sides of every happens-before edge instrumented).  The reference adds
// test entry points to its library for the alias; the port keeps its
// library as it is and compiles the ring into this harness's translation
// unit instead (the #include below), so the alias is made here.
//
// Scope: the SPSC protocol itself (head/tail publication, wrap markers,
// payload visibility, backpressure) across several ring generations
// (create -> stream -> drain -> close -> recreate), with the records the
// port writes: bjr_write_v's framed payload (u32 nframes | u64 len[] |
// bytes).  The create/open handshake across two mappings is not
// TSAN-instrumentable by nature; its ordering is enforced in ringbuf.cpp
// (Header::magic release/acquire).
//
// Build and run (tests/test_torch_ring_stress.py does, under a temporary
// directory):
//   g++ -O1 -g -std=c++17 -Wall -fsanitize=thread tsan_stress.cpp -o tsan_stress -lrt -pthread
//   ./tsan_stress    # exit 0 and no ThreadSanitizer report = pass

#include "ringbuf.cpp"

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr int kGenerations = 4;
constexpr uint64_t kPerGen = 4000;
constexpr uint64_t kCap = 1 << 16;  // small ring: constant wrap pressure
constexpr uint64_t kFrameAt = 4 + 8;  // one frame: u32 count, u64 length, bytes

const char* kName = nullptr;

std::atomic<void*> g_writer_handle{nullptr};
std::atomic<int> g_pub_gen{-1};  // generation whose handle is published
std::atomic<int> g_ack_gen{-1};  // last generation fully drained by reader
std::atomic<bool> fail{false};

void check(bool ok, const char* what) {
  if (!ok) {
    std::fprintf(stderr, "FAIL: %s\n", what);
    fail.store(true);
  }
}

// a reader Handle over the writer's own mapping; it owns nothing
void* alias_reader(void* handle) {
  auto* h = new Handle(*static_cast<Handle*>(handle));
  h->owner = 0;
  h->last_rec = 0;
  h->next_vanish_check_ms = 0;
  return h;
}

void free_alias(void* handle) { delete static_cast<Handle*>(handle); }

void writer() {
  for (int gen = 0; gen < kGenerations; ++gen) {
    void* h = bjr_create(kName, kCap);
    check(h != nullptr, "bjr_create");
    if (!h) return;
    g_writer_handle.store(h, std::memory_order_release);
    g_pub_gen.store(gen, std::memory_order_release);
    // varied record sizes: wrap-marker and padding paths under load; the
    // small capacity keeps writer and reader in constant contention on
    // head/tail while payload memcpys race the reader's copy-outs
    unsigned char buf[1500];
    for (uint64_t i = 0; i < kPerGen; ++i) {
      uint64_t stamp[2] = {static_cast<uint64_t>(gen), i};
      std::memcpy(buf, stamp, 16);
      uint64_t len = 16 + (i * 37) % (sizeof(buf) - 16);
      const void* bufs[1] = {buf};
      int rc = bjr_write_v(h, bufs, &len, 1, 5000);
      check(rc == 0, "bjr_write_v");
      if (rc != 0) break;
    }
    // the reader aliases THIS mapping: close (munmap) strictly after the
    // reader acked the generation; it acks on failure paths too, so the
    // wait can neither deadlock nor unmap pages the reader still reads
    while (g_ack_gen.load(std::memory_order_acquire) < gen) {
      usleep(100);
    }
    bjr_close(h, /*unlink_shm=*/1);
    if (fail.load()) return;
  }
}

void reader() {
  for (int gen = 0; gen < kGenerations; ++gen) {
    while (g_pub_gen.load(std::memory_order_acquire) < gen) {
      if (fail.load()) return;  // writer aborted: nothing will be published
      usleep(100);
    }
    void* alias = alias_reader(g_writer_handle.load(std::memory_order_acquire));
    uint64_t got = 0;
    while (got < kPerGen) {
      const void* data = nullptr;
      uint64_t len = 0;
      int rc = bjr_read_acquire(alias, &data, &len, 2000);
      if (rc == -1) {
        check(false, "reader starved (writer stalled?)");
        break;
      }
      check(rc == 0, "bjr_read_acquire");
      if (rc != 0) break;
      const auto* rec = static_cast<const unsigned char*>(data);
      uint32_t nframes = 0;
      uint64_t flen = 0;
      check(len >= kFrameAt + 16, "record length");
      std::memcpy(&nframes, rec, 4);
      std::memcpy(&flen, rec + 4, 8);
      check(nframes == 1 && flen + kFrameAt == len, "framed record layout");
      uint64_t stamp[2];
      std::memcpy(stamp, rec + kFrameAt, 16);
      check(stamp[0] == static_cast<uint64_t>(gen), "generation stamp");
      check(stamp[1] == got, "SPSC lost or reordered a record");
      (void)bjr_pending(alias);  // concurrent head load vs writer stores
      bjr_read_release(alias);
      ++got;
    }
    free_alias(alias);
    g_ack_gen.store(gen, std::memory_order_release);
    if (fail.load()) return;
  }
  std::fprintf(stderr, "reader drained %d generations x %llu records\n",
               kGenerations, static_cast<unsigned long long>(kPerGen));
}

}  // namespace

int main() {
  char name[128];
  std::snprintf(name, sizeof(name), "bjx-torch-tsan-stress-%d", getpid());
  kName = name;
  std::thread w(writer);
  std::thread r(reader);
  w.join();
  r.join();
  shm_unlink(name);
  if (fail.load()) return 1;
  std::puts("tsan stress ok");
  return 0;
}
