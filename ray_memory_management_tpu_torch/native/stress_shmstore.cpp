// Multi-threaded stress test for the shared-memory object store.
//
// The reference's race-detection story runs its C++ suite under
// TSAN/ASAN bazel configs (.bazelrc:92-106). This binary is the analog
// for the native store: N threads hammer create/write/seal/get/release/
// contains/delete on a shared store, verifying payload integrity and
// lifecycle rules (get-before-seal fails, delete-while-referenced
// fails). native/build.py builds it plain (`program_path("stress")`) or
// under a sanitizer (`"stress_tsan"`, `"stress_asan"`); run it with
// TSAN_OPTIONS=halt_on_error=1 under TSan. Any data race, lock bug, or
// heap corruption trips the sanitizer or the integrity checks and exits
// non-zero.

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t store_create(const char* name, uint64_t capacity);
int64_t store_open(const char* name);
void store_close(int64_t h);
int store_unlink(const char* name);
uint64_t store_capacity(int64_t h);
int64_t obj_create(int64_t h, const uint8_t* id, uint64_t size);
int obj_seal(int64_t h, const uint8_t* id);
int obj_get(int64_t h, const uint8_t* id, uint64_t* off, uint64_t* size,
            int inc_ref);
int obj_release(int64_t h, const uint8_t* id);
int obj_delete(int64_t h, const uint8_t* id);
int obj_contains(int64_t h, const uint8_t* id);
void store_usage(int64_t h, uint64_t* used, uint64_t* capacity,
                 uint64_t* num_objects);
}

namespace {

constexpr int kThreads = 8;
constexpr int kItersPerThread = 4000;
constexpr int kIdSpace = 64;
std::atomic<int> failures{0};

void fail(const char* what, int rc) {
  fprintf(stderr, "FAIL: %s rc=%d\n", what, rc);
  failures.fetch_add(1);
}

void make_id(uint8_t* id, int slot, int tid) {
  memset(id, 0, 16);
  id[0] = (uint8_t)slot;
  id[1] = (uint8_t)tid;
  id[15] = 0x5a;
}

void worker(int64_t h, uint8_t* base, int tid) {
  uint8_t id[16];
  uint64_t goff, gsize;
  for (int i = 0; i < kItersPerThread; i++) {
    int slot = (int)((i * 2654435761u + (unsigned)tid) % kIdSpace);
    make_id(id, slot, tid);  // ids are (slot, tid): each thread owns its
                             // ids, but allocator/table/lock are shared
    uint64_t size = 64 + (uint64_t)(slot * 97) % 4096;
    int64_t off = obj_create(h, id, size);
    if (off == -2) continue;          // table slot contention: skip
    if (off <= 0) {                   // exists from an earlier round
      obj_delete(h, id);
      continue;
    }
    // lifecycle rule: get before seal must fail
    if (obj_get(h, id, &goff, &gsize, 0) == 0) fail("get-unsealed", 0);
    uint8_t* payload = base + off;
    memset(payload, (uint8_t)slot, size);
    int rc = obj_seal(h, id);
    if (rc != 0) {
      fail("seal", rc);
      continue;
    }
    rc = obj_get(h, id, &goff, &gsize, 1);
    if (rc != 0) {
      fail("get", rc);
      continue;
    }
    if (goff != (uint64_t)off || gsize != size) fail("geom", 0);
    uint8_t* view = base + goff;
    if (view[0] != (uint8_t)slot || view[gsize - 1] != (uint8_t)slot) {
      fail("integrity", 0);
    }
    // lifecycle rule: delete while referenced must fail
    if (obj_delete(h, id) != -2) fail("delete-while-ref", 0);
    if (obj_release(h, id) != 0) fail("release", 0);
    if (i % 3 == 0) {
      if (obj_contains(h, id) != 1) fail("contains", 0);
      if (obj_delete(h, id) != 0) fail("delete", 0);
    }
  }
}

}  // namespace

int main() {
  // one name per process: two runs at once (a plain and a sanitized
  // build, or two test workers) must not unlink each other's store
  char name[64];
  snprintf(name, sizeof(name), "/rmt_stress_store_%d", int(getpid()));
  store_unlink(name);
  int64_t h = store_create(name, 256ull << 20);
  if (h < 0) {
    fprintf(stderr, "store_create failed\n");
    return 2;
  }
  // clients address payloads by offset from their own mapping of the
  // store file (what the Python StoreClient does via mmap)
  int fd = shm_open(name, O_RDWR, 0600);
  uint64_t cap = store_capacity(h);
  uint8_t* base = (uint8_t*)mmap(nullptr, cap, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    fprintf(stderr, "mmap failed\n");
    return 2;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; t++) {
    threads.emplace_back(worker, h, base, t);
  }
  for (auto& th : threads) th.join();
  uint64_t used, capacity, num;
  store_usage(h, &used, &capacity, &num);
  fprintf(stderr, "done: used=%llu cap=%llu objects=%llu failures=%d\n",
          (unsigned long long)used, (unsigned long long)capacity,
          (unsigned long long)num, failures.load());
  munmap(base, cap);
  store_close(h);
  store_unlink(name);
  if (failures.load() != 0) return 1;
  printf("STRESS OK\n");
  return 0;
}
