// shm_channel: single-producer single-consumer shared-memory ring channel.
//
// TPU-native analog of the reference's mutable plasma objects — the
// zero-copy transport under compiled graphs (reference:
// src/ray/core_worker/experimental_mutable_object_manager.h WriteAcquire
// :153 / ReadAcquire, experimental/channel/shared_memory_channel.py).
// Semantics match the reference's acquire/release protocol, generalized
// from one slot to a small ring so pipeline stages can run ahead:
//
//   writer: rt_chan_write_acquire -> largest free slot buffer (blocks while
//           the ring is full, i.e. reader is `nslots` versions behind)
//           rt_chan_write_release(nbytes) -> publishes the new version
//   reader: rt_chan_read_acquire -> blocks until an unread version exists,
//           returns (offset, nbytes); rt_chan_read_release frees the slot
//
// Progress uses C++11 atomics on the mapped header + bounded exponential
// backoff (spin -> usleep), no mutex: SPSC needs none, and a crashed peer
// can't strand a lock.  Timeouts return -2 so callers can poll their stop
// flags; a closed channel returns -3 (writer side sets the closed bit).
//
// C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254434841ULL;  // "RTCHA"
constexpr uint64_t kPage = 4096;

struct ChanHeader {
  uint64_t magic;
  uint64_t slot_size;
  uint32_t nslots;
  uint32_t initialized;
  std::atomic<uint64_t> write_seq;  // versions published
  std::atomic<uint64_t> read_seq;   // versions consumed
  std::atomic<uint32_t> closed;
  uint32_t pad;
  // per-slot payload byte counts
  std::atomic<uint64_t> slot_bytes[64];
};

struct Chan {
  int fd;
  uint8_t* base;
  uint64_t map_len;
  ChanHeader* hdr;
  uint64_t data_off;
};

uint64_t page_round(uint64_t n) { return (n + kPage - 1) & ~(kPage - 1); }

// bounded backoff wait; pred returns true to stop. timeout_us<0 = forever.
template <typename F>
bool wait_until(F pred, int64_t timeout_us) {
  int spins = 0;
  int64_t waited = 0;
  while (!pred()) {
    if (spins < 1024) {
      ++spins;
    } else {
      int64_t us = spins < 4096 ? 50 : 500;
      spins++;
      usleep((useconds_t)us);
      waited += us;
      if (timeout_us >= 0 && waited > timeout_us) return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Create or attach.  nslots <= 64.  Returns NULL on failure.
Chan* rt_chan_open(const char* path, uint64_t slot_size, uint32_t nslots) {
  if (nslots == 0 || nslots > 64) return nullptr;
  slot_size = page_round(slot_size);
  uint64_t data_off = page_round(sizeof(ChanHeader));
  uint64_t total = data_off + slot_size * nslots;

  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  bool creator = fd >= 0;
  if (!creator) {
    if (errno != EEXIST) return nullptr;
    fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
    ChanHeader probe;
    for (int spin = 0; spin < 50000; ++spin) {
      ssize_t n = pread(fd, &probe, sizeof(uint64_t) * 4, 0);
      if (n >= (ssize_t)(sizeof(uint64_t) * 2) && probe.magic == kMagic)
        break;
      usleep(100);
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < total) {
      // attach with the creator's geometry
      if (pread(fd, &probe, sizeof(uint64_t) * 4, 0) !=
          (ssize_t)(sizeof(uint64_t) * 4)) {
        close(fd);
        return nullptr;
      }
    }
    if (pread(fd, &probe, sizeof(uint64_t) * 4, 0) ==
        (ssize_t)(sizeof(uint64_t) * 4) && probe.magic == kMagic) {
      slot_size = probe.slot_size;
      nslots = probe.nslots;
      total = data_off + slot_size * nslots;
    }
  } else {
    if (ftruncate(fd, (off_t)total) != 0) {
      close(fd);
      unlink(path);
      return nullptr;
    }
  }

  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Chan* c = new Chan;
  c->fd = fd;
  c->base = (uint8_t*)base;
  c->map_len = total;
  c->hdr = (ChanHeader*)base;
  c->data_off = data_off;
  if (creator) {
    memset(base, 0, data_off);
    c->hdr->slot_size = slot_size;
    c->hdr->nslots = nslots;
    c->hdr->write_seq.store(0);
    c->hdr->read_seq.store(0);
    c->hdr->closed.store(0);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    c->hdr->magic = kMagic;
    c->hdr->initialized = 1;
  } else {
    wait_until([&] { return c->hdr->initialized != 0; }, 5000000);
  }
  return c;
}

void rt_chan_close_handle(Chan* c) {
  if (!c) return;
  munmap(c->base, c->map_len);
  close(c->fd);
  delete c;
}

uint64_t rt_chan_slot_size(Chan* c) { return c ? c->hdr->slot_size : 0; }

// Writer: reserve the next slot.  Returns payload offset, or
// -2 on timeout, -3 if closed.
int64_t rt_chan_write_acquire(Chan* c, int64_t timeout_us) {
  if (!c) return -3;
  ChanHeader* h = c->hdr;
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  bool ok = wait_until(
      [&] {
        return h->closed.load(std::memory_order_relaxed) ||
               w - h->read_seq.load(std::memory_order_acquire) < h->nslots;
      },
      timeout_us);
  if (h->closed.load(std::memory_order_relaxed)) return -3;
  if (!ok) return -2;
  return (int64_t)(c->data_off + (w % h->nslots) * h->slot_size);
}

// Writer: publish nbytes written into the acquired slot.
int rt_chan_write_release(Chan* c, uint64_t nbytes) {
  if (!c) return -1;
  ChanHeader* h = c->hdr;
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  h->slot_bytes[w % h->nslots].store(nbytes, std::memory_order_relaxed);
  h->write_seq.store(w + 1, std::memory_order_release);
  return 0;
}

// Reader: wait for an unread version.  On success stores nbytes and
// returns the payload offset; -2 on timeout; -3 closed AND drained.
int64_t rt_chan_read_acquire(Chan* c, uint64_t* nbytes, int64_t timeout_us) {
  if (!c) return -3;
  ChanHeader* h = c->hdr;
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  bool ok = wait_until(
      [&] {
        return h->write_seq.load(std::memory_order_acquire) > r ||
               h->closed.load(std::memory_order_relaxed);
      },
      timeout_us);
  if (h->write_seq.load(std::memory_order_acquire) <= r) {
    return h->closed.load(std::memory_order_relaxed) ? -3 : -2;
  }
  if (!ok) return -2;
  *nbytes = h->slot_bytes[r % h->nslots].load(std::memory_order_relaxed);
  return (int64_t)(c->data_off + (r % h->nslots) * h->slot_size);
}

// Reader: free the slot for the writer.
int rt_chan_read_release(Chan* c) {
  if (!c) return -1;
  ChanHeader* h = c->hdr;
  h->read_seq.fetch_add(1, std::memory_order_release);
  return 0;
}

void rt_chan_close(Chan* c) {
  if (c) c->hdr->closed.store(1, std::memory_order_release);
}

int rt_chan_is_closed(Chan* c) {
  return c ? (int)c->hdr->closed.load(std::memory_order_relaxed) : 1;
}

}  // extern "C"
