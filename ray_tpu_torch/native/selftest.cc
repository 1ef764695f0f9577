// Sanitizer self-test driver for the native components.
//
// The reference runs its C++ unit tests under ASAN/TSAN bazel configs
// (.bazelrc asan/tsan); here the native pieces are small enough that one
// driver exercises each C ABI end to end and the whole binary is built
// with -fsanitize=address,undefined (ray_tpu_torch/native/build.py --sanitize,
// run by tests/test_torch_native_sanitize.py).  Exit 0 = no assertion failed
// AND no sanitizer report (sanitizers abort non-zero on findings).
//
// Build: g++ -std=c++17 -g -O1 -fsanitize=address,undefined \
//            selftest.cc shm_arena.cc shm_channel.cc sched.cc -lpthread

#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unistd.h>

// C ABI surfaces (the .cc files define them; declared here rather than
// shared headers because the production consumers are ctypes callers)
struct Arena;
struct Chan;
extern "C" {
Arena* rt_arena_open(const char* path, uint64_t capacity, uint32_t n_entries);
void rt_arena_close(Arena* a);
uint64_t rt_create(Arena* a, const char* id, uint64_t size, int* err,
                   uint32_t flags);
int rt_seal(Arena* a, const char* id);
int rt_abort(Arena* a, const char* id);
uint64_t rt_get(Arena* a, const char* id, uint64_t* size);
int rt_release(Arena* a, const char* id);
int rt_delete(Arena* a, const char* id);
int64_t rt_get_flags(Arena* a, const char* id);
int rt_set_primary(Arena* a, const char* id, int on);
int rt_contains(Arena* a, const char* id);
int64_t rt_size(Arena* a, const char* id);
uint64_t rt_list(Arena* a, char* buf, uint64_t buflen);
void rt_memcpy(void* dst, const void* src, uint64_t n);
void rt_stats(Arena* a, uint64_t* capacity, uint64_t* used, uint64_t* nobj,
              uint64_t* npinned);

Chan* rt_chan_open(const char* path, uint64_t slot_size, uint32_t nslots);
void rt_chan_close_handle(Chan* c);
uint64_t rt_chan_slot_size(Chan* c);
int64_t rt_chan_write_acquire(Chan* c, int64_t timeout_us);
int rt_chan_write_release(Chan* c, uint64_t nbytes);
int64_t rt_chan_read_acquire(Chan* c, uint64_t* nbytes, int64_t timeout_us);
int rt_chan_read_release(Chan* c);
void rt_chan_close(Chan* c);
int rt_chan_is_closed(Chan* c);

void* rsched_create(double spread_threshold, int topk);
void rsched_destroy(void* h);
int rsched_intern(void* h, const char* name);
void rsched_upsert_node(void* h, const char* node_id, const int* ids,
                        const int64_t* totals, int cnt);
void rsched_set_alive(void* h, const char* node_id, int alive);
void rsched_remove_node(void* h, const char* node_id);
void rsched_set_avail(void* h, const char* node_id, const int* ids,
                      const int64_t* avail, int cnt);
int rsched_acquire(void* h, const char* node_id, const int* ids,
                   const int64_t* demand, int cnt);
void rsched_release(void* h, const char* node_id, const int* ids,
                    const int64_t* demand, int cnt);
int rsched_pick(void* h, const int* ids, const int64_t* demand, int cnt,
                int strategy, char* out, int out_cap);
}

static void test_arena(const std::string& dir) {
  std::string path = dir + "/arena.bin";
  unlink(path.c_str());            // a prior aborted run may have left one
  Arena* a = rt_arena_open(path.c_str(), 1 << 20, 64);
  assert(a);
  int err = 7;
  uint64_t off = rt_create(a, "obj-1", 4096, &err, 0);
  assert(off != 0 && err == 0);
  assert(rt_contains(a, "obj-1") == 0);   // unsealed: not yet visible
  assert(rt_seal(a, "obj-1") == 0);
  assert(rt_contains(a, "obj-1") == 1);
  uint64_t size = 0;
  assert(rt_get(a, "obj-1", &size) != 0 && size == 4096);
  assert(rt_size(a, "obj-1") == 4096);
  assert(rt_set_primary(a, "obj-1", 1) == 0);
  assert(rt_get_flags(a, "obj-1") >= 0);
  assert(rt_release(a, "obj-1") == 0);

  // abort path
  assert(rt_create(a, "obj-2", 128, &err, 0) != 0 && err == 0);
  assert(rt_abort(a, "obj-2") == 0);
  assert(rt_contains(a, "obj-2") == 0);

  // fill enough objects to exercise the extent allocator + list
  for (int i = 0; i < 20; ++i) {
    char id[32];
    snprintf(id, sizeof id, "bulk-%d", i);
    assert(rt_create(a, id, 8192, &err, 0) != 0 && err == 0);
    assert(rt_seal(a, id) == 0);
    uint64_t sz = 0;
    assert(rt_get(a, id, &sz) != 0 && sz == 8192);   // pins a reader ref
    assert(rt_release(a, id) == 0);                  // ...and drops it
  }
  char listbuf[4096];
  uint64_t n = rt_list(a, listbuf, sizeof listbuf);
  assert(n >= 21);
  uint64_t cap, used, nobj, npinned;
  rt_stats(a, &cap, &used, &nobj, &npinned);
  assert(nobj == n && used > 0 && cap >= used);
  for (int i = 0; i < 20; i += 2) {
    char id[32];
    snprintf(id, sizeof id, "bulk-%d", i);
    assert(rt_delete(a, id) == 0);
  }
  // memcpy helper on our own buffers
  char srcb[256], dstb[256];
  memset(srcb, 0x5a, sizeof srcb);
  rt_memcpy(dstb, srcb, sizeof dstb);
  assert(memcmp(srcb, dstb, sizeof dstb) == 0);
  rt_arena_close(a);
  unlink(path.c_str());
  printf("arena: ok\n");
}

static void test_chan(const std::string& dir) {
  std::string path = dir + "/chan.bin";
  unlink(path.c_str());
  Chan* w = rt_chan_open(path.c_str(), 4096, 4);
  Chan* r = rt_chan_open(path.c_str(), 4096, 4);
  assert(w && r && rt_chan_slot_size(w) >= 4096);
  for (int round = 0; round < 10; ++round) {
    int64_t woff = rt_chan_write_acquire(w, 1000000);
    assert(woff >= 0);
    assert(rt_chan_write_release(w, 100 + round) == 0);
    uint64_t nbytes = 0;
    int64_t roff = rt_chan_read_acquire(r, &nbytes, 1000000);
    assert(roff >= 0 && nbytes == (uint64_t)(100 + round));
    assert(rt_chan_read_release(r) == 0);
  }
  // fill the ring: the 5th un-read write must time out, not corrupt
  for (int i = 0; i < 4; ++i) {
    assert(rt_chan_write_acquire(w, 1000000) >= 0);
    assert(rt_chan_write_release(w, 1) == 0);
  }
  assert(rt_chan_write_acquire(w, 1000) < 0);
  rt_chan_close(w);
  assert(rt_chan_is_closed(r) == 1);
  rt_chan_close_handle(w);
  rt_chan_close_handle(r);
  unlink(path.c_str());
  printf("chan: ok\n");
}

static void test_sched() {
  void* s = rsched_create(0.5, 2);
  assert(s);
  int cpu = rsched_intern(s, "CPU");
  int tpu = rsched_intern(s, "TPU");
  assert(cpu != tpu && rsched_intern(s, "CPU") == cpu);
  int ids[2] = {cpu, tpu};
  int64_t totals_a[2] = {8, 4};
  int64_t totals_b[2] = {16, 0};
  rsched_upsert_node(s, "node-a", ids, totals_a, 2);
  rsched_upsert_node(s, "node-b", ids, totals_b, 2);
  rsched_set_avail(s, "node-a", ids, totals_a, 2);
  rsched_set_avail(s, "node-b", ids, totals_b, 2);

  int64_t want_tpu[2] = {1, 1};
  char out[64];
  assert(rsched_pick(s, ids, want_tpu, 2, 0, out, sizeof out) == 1);
  assert(std::string(out) == "node-a");   // only node with TPU
  assert(rsched_acquire(s, "node-a", ids, want_tpu, 2) == 1);
  rsched_release(s, "node-a", ids, want_tpu, 2);

  rsched_set_alive(s, "node-a", 0);
  assert(rsched_pick(s, ids, want_tpu, 2, 0, out, sizeof out) == 0);
  rsched_set_alive(s, "node-a", 1);
  rsched_remove_node(s, "node-b");
  assert(rsched_pick(s, ids, want_tpu, 2, 0, out, sizeof out) == 1);
  rsched_destroy(s);
  printf("sched: ok\n");
}

int main(int argc, char** argv) {
  std::string dir = argc > 1 ? argv[1] : "/tmp";
  test_arena(dir);
  test_chan(dir);
  test_sched();
  printf("native selftest: ALL OK\n");
  return 0;
}
