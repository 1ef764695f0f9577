// shm_arena: node-local shared-memory object arena (plasma equivalent).
//
// TPU-native redesign of the reference's plasma store (reference:
// src/ray/object_manager/plasma/store.h, object_lifecycle_manager.h,
// eviction_policy.h, plasma_allocator.h).  Instead of a store *process*
// that clients talk to over a unix socket with fd passing (plasma/fling.h),
// the whole store is a single mmap-backed arena file that every process on
// the node maps directly:
//
//   * allocation / table ops take a robust process-shared mutex held for
//     microseconds — there is no store round-trip on any path;
//   * object payloads are page-aligned, so a reader maps just its object
//     (offset-aligned mmap) and reads zero-copy;
//   * readers register (pid, count) pins; eviction validates pins with
//     kill(pid, 0) so crashed readers cannot leak pins forever (the role
//     plasma's client-socket-disconnect cleanup plays);
//   * LRU eviction of sealed, unpinned objects runs inline in the
//     allocating process when the arena is full (reference:
//     plasma/eviction_policy.h LRUCache), instead of in a store daemon.
//
// All allocator metadata (object table + free-extent list) lives in the
// arena header region, never interleaved with payload bytes, so a crashed
// writer cannot corrupt block linkage.  The file is sparse: pages cost
// physical memory only once touched.
//
// C ABI only — consumed from Python via ctypes (no pybind11 in the image).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x524159545055ULL;  // "RAYTPU"
constexpr uint32_t kVersion = 3;  // 3: Header gained high_water
constexpr uint64_t kPage = 4096;
constexpr uint32_t kMaxReaders = 8;
constexpr uint32_t kIdLen = 64;  // incl. NUL

// entry states
constexpr uint32_t kEmpty = 0;
constexpr uint32_t kCreated = 1;  // allocated, being written
constexpr uint32_t kSealed = 2;
constexpr uint32_t kTomb = 3;  // deleted; probe chains continue through it

// entry flags
// Primary copy: the only in-memory copy of an owned object.  Never a
// victim of LRU eviction — it must be spilled to disk (and the flag
// cleared) before its memory can be reclaimed, mirroring plasma's
// pinned-primary rule (reference: local_object_manager.h pinned_objects_;
// eviction only reaps secondary copies).
constexpr uint32_t kFlagPrimary = 1;
// rt_create-only flag (never stored in Entry.flags): fail instead of
// growing the touched region past high_water — the caller can free
// grace-delayed garbage and retry warm before paying first-touch cost.
constexpr uint32_t kFlagWarmOnly = 1u << 30;

struct Reader {
  uint32_t pid;
  int32_t count;
};

struct Entry {
  uint64_t hash;      // 0 means look at state (empty vs tomb)
  uint32_t state;
  uint32_t creator_pid;
  uint32_t flags;
  uint32_t pad0;
  uint64_t off;       // payload offset in arena (page aligned)
  uint64_t size;      // payload bytes (allocated extent = page-rounded)
  uint64_t lru_tick;  // larger = more recently used
  Reader readers[kMaxReaders];
  char id[kIdLen];
};

struct Extent {
  uint64_t off;
  uint64_t len;
};

struct Header {
  uint64_t magic;
  uint32_t version;
  uint32_t initialized;  // set last by creator
  uint64_t capacity;     // total file size
  uint64_t data_off;     // start of payload region
  uint64_t data_len;
  uint32_t n_entries;
  uint32_t n_extents_max;
  uint64_t table_off;    // Entry[n_entries]
  uint64_t extents_off;  // Extent[n_extents_max], sorted by off
  uint32_t n_extents;
  uint32_t pad0;
  uint64_t lru_clock;
  uint64_t bytes_used;
  uint64_t n_objects;
  uint64_t n_evictions;
  uint64_t high_water;   // max data offset ever handed out (see extent_alloc)
  pthread_mutex_t mu;
};

struct Arena {
  int fd;
  uint8_t* base;
  uint64_t map_len;  // header + table + extents only (payload mapped by users)
  Header* hdr;
  Entry* table;
  Extent* extents;
};

uint64_t fnv1a(const char* s) {
  uint64_t h = 1469598103934665603ULL;
  for (; *s; ++s) {
    h ^= (uint8_t)*s;
    h *= 1099511628211ULL;
  }
  return h ? h : 1;  // 0 is the empty marker
}

uint64_t page_round(uint64_t n) { return (n + kPage - 1) & ~(kPage - 1); }

// ---- locking ---------------------------------------------------------------

int lock(Arena* a) {
  int rc = pthread_mutex_lock(&a->hdr->mu);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock.  Table mutations are single-store
    // writes (state flips) or array ops completed under the lock; recover
    // by dropping unsealed entries owned by dead creators.
    pthread_mutex_consistent(&a->hdr->mu);
    for (uint32_t i = 0; i < a->hdr->n_entries; ++i) {
      Entry& e = a->table[i];
      if (e.state == kCreated && e.creator_pid != 0 &&
          kill((pid_t)e.creator_pid, 0) != 0 && errno == ESRCH) {
        e.state = kTomb;  // extent leaks until destroy; rare + bounded
      }
    }
    rc = 0;
  }
  return rc;
}

void unlock(Arena* a) { pthread_mutex_unlock(&a->hdr->mu); }

// ---- free-extent allocator (metadata in header region) ---------------------

// Insert [off, off+len) into the sorted extent list, coalescing neighbors.
void extent_free(Header* h, Extent* ex, uint64_t off, uint64_t len) {
  uint32_t n = h->n_extents;
  uint32_t i = 0;
  while (i < n && ex[i].off < off) ++i;
  bool merge_prev = i > 0 && ex[i - 1].off + ex[i - 1].len == off;
  bool merge_next = i < n && off + len == ex[i].off;
  if (merge_prev && merge_next) {
    ex[i - 1].len += len + ex[i].len;
    memmove(&ex[i], &ex[i + 1], (n - i - 1) * sizeof(Extent));
    h->n_extents = n - 1;
  } else if (merge_prev) {
    ex[i - 1].len += len;
  } else if (merge_next) {
    ex[i].off = off;
    ex[i].len += len;
  } else {
    if (n >= h->n_extents_max) return;  // can't record; leak (bounded)
    memmove(&ex[i + 1], &ex[i], (n - i) * sizeof(Extent));
    ex[i].off = off;
    ex[i].len = len;
    h->n_extents = n + 1;
  }
}

// Allocation of a page-rounded length; returns 0 on failure.
//
// Warm-first policy: prefer extents that start below the high-water mark
// (space that has been allocated before — its pages are already faulted
// in and zeroed), and only grow into virgin tail space when no recycled
// extent fits.  A plain lowest-offset first-fit over a large arena
// marches through cold pages for the whole first cycle (every put pays
// first-touch zero-fill, about half of memcpy bandwidth); with this
// policy the touched working set stays as small as the live set needs.
uint64_t extent_take(Header* h, Extent* ex, uint32_t i, uint64_t len) {
  uint64_t off = ex[i].off;
  ex[i].off += len;
  ex[i].len -= len;
  if (ex[i].len == 0) {
    memmove(&ex[i], &ex[i + 1], (h->n_extents - i - 1) * sizeof(Extent));
    h->n_extents--;
  }
  if (off + len > h->high_water) h->high_water = off + len;
  return off;
}

uint64_t extent_alloc(Header* h, Extent* ex, uint64_t len, bool warm_only) {
  for (uint32_t i = 0; i < h->n_extents; ++i) {
    if (ex[i].len >= len && ex[i].off < h->high_water)
      return extent_take(h, ex, i, len);
  }
  if (warm_only) return 0;
  for (uint32_t i = 0; i < h->n_extents; ++i) {
    if (ex[i].len >= len) return extent_take(h, ex, i, len);
  }
  return 0;
}

// ---- object table ----------------------------------------------------------

Entry* find_entry(Arena* a, const char* id, uint64_t h) {
  uint32_t mask = a->hdr->n_entries - 1;
  uint32_t i = (uint32_t)h & mask;
  for (uint32_t probes = 0; probes < a->hdr->n_entries; ++probes) {
    Entry& e = a->table[i];
    if (e.state == kEmpty) return nullptr;
    if (e.state != kTomb && e.hash == h && strncmp(e.id, id, kIdLen) == 0)
      return &e;
    i = (i + 1) & mask;
  }
  return nullptr;
}

Entry* find_slot(Arena* a, const char* id, uint64_t h) {
  uint32_t mask = a->hdr->n_entries - 1;
  uint32_t i = (uint32_t)h & mask;
  Entry* tomb = nullptr;
  for (uint32_t probes = 0; probes < a->hdr->n_entries; ++probes) {
    Entry& e = a->table[i];
    if (e.state == kEmpty) return tomb ? tomb : &e;
    if (e.state == kTomb) {
      if (!tomb) tomb = &e;
    } else if (e.hash == h && strncmp(e.id, id, kIdLen) == 0) {
      return &e;  // caller checks state
    }
    i = (i + 1) & mask;
  }
  return tomb;
}

bool pinned(Entry& e) {
  for (uint32_t r = 0; r < kMaxReaders; ++r) {
    if (e.readers[r].count > 0) {
      if (kill((pid_t)e.readers[r].pid, 0) != 0 && errno == ESRCH) {
        e.readers[r].count = 0;  // crashed reader: reclaim the pin
        e.readers[r].pid = 0;
      } else {
        return true;
      }
    }
  }
  return false;
}

void drop_object(Arena* a, Entry* e) {
  extent_free(a->hdr, a->extents, e->off, page_round(e->size ? e->size : 1));
  a->hdr->bytes_used -= page_round(e->size ? e->size : 1);
  a->hdr->n_objects--;
  e->state = kTomb;
  e->creator_pid = 0;
  memset(e->readers, 0, sizeof(e->readers));
}

// Evict sealed, unpinned objects in LRU order until `need` bytes can be
// allocated; returns the allocated offset or 0.
uint64_t alloc_with_eviction(Arena* a, uint64_t need, bool warm_only) {
  uint64_t off = extent_alloc(a->hdr, a->extents, need, warm_only);
  // warm_only is a cheap probe: never evict for it — if the probe fails,
  // the caller frees its own garbage and retries, and only the final
  // unconstrained create should spend cached copies on making room
  if (warm_only) return off;
  while (off == 0) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < a->hdr->n_entries; ++i) {
      Entry& e = a->table[i];
      if (e.state == kSealed && !(e.flags & kFlagPrimary) && !pinned(e) &&
          (!victim || e.lru_tick < victim->lru_tick))
        victim = &e;
    }
    if (!victim) return 0;
    drop_object(a, victim);
    a->hdr->n_evictions++;
    off = extent_alloc(a->hdr, a->extents, need, warm_only);
  }
  return off;
}

}  // namespace

extern "C" {

// Create (or attach to, if it already exists) the arena at `path`.
// `capacity` is the payload (data region) size — table/extent metadata is
// allocated on top.  n_entries must be a power of two.  NULL on failure.
Arena* rt_arena_open(const char* path, uint64_t capacity, uint32_t n_entries) {
  if (n_entries == 0 || (n_entries & (n_entries - 1))) return nullptr;
  uint64_t table_off = page_round(sizeof(Header));
  uint64_t extents_off = page_round(table_off + n_entries * sizeof(Entry));
  uint32_t n_extents_max = n_entries;
  uint64_t data_off = page_round(extents_off + n_extents_max * sizeof(Extent));
  uint64_t data_len = page_round(capacity < (64 << 10) ? (64 << 10) : capacity);
  capacity = data_off + data_len;

  int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  bool creator = fd >= 0;
  if (!creator) {
    if (errno != EEXIST) return nullptr;
    fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
    // wait for the creator to finish initializing
    Header probe;
    for (int spin = 0; spin < 50000; ++spin) {
      ssize_t n = pread(fd, &probe, sizeof(probe), 0);
      if (n == (ssize_t)sizeof(probe) && probe.magic == kMagic &&
          probe.initialized)
        break;
      usleep(100);
    }
    // reject attaches across layout versions: Entry's stride changed in
    // v2, so a mismatched attacher would misread the whole entry table
    if (pread(fd, &probe, sizeof(probe), 0) != (ssize_t)sizeof(probe) ||
        probe.magic != kMagic || !probe.initialized ||
        probe.version != kVersion) {
      close(fd);
      return nullptr;
    }
    table_off = probe.table_off;
    extents_off = probe.extents_off;
    n_entries = probe.n_entries;
    n_extents_max = probe.n_extents_max;
    data_off = probe.data_off;
    capacity = probe.capacity;
  } else {
    if (ftruncate(fd, (off_t)capacity) != 0) {
      close(fd);
      unlink(path);
      return nullptr;
    }
  }

  uint64_t map_len = data_off;  // metadata only; payloads mapped per-object
  void* base =
      mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Arena* a = new Arena;
  a->fd = fd;
  a->base = (uint8_t*)base;
  a->map_len = map_len;
  a->hdr = (Header*)base;
  a->table = (Entry*)(a->base + table_off);
  a->extents = (Extent*)(a->base + extents_off);

  if (creator) {
    Header* h = a->hdr;
    memset(h, 0, sizeof(Header));
    h->magic = kMagic;
    h->version = kVersion;
    h->capacity = capacity;
    h->data_off = data_off;
    h->data_len = capacity - data_off;
    h->n_entries = n_entries;
    h->n_extents_max = n_extents_max;
    h->table_off = table_off;
    h->extents_off = extents_off;
    h->n_extents = 1;
    a->extents[0].off = data_off;
    a->extents[0].len = capacity - data_off;
    pthread_mutexattr_t at;
    pthread_mutexattr_init(&at);
    pthread_mutexattr_setpshared(&at, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&at, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mu, &at);
    pthread_mutexattr_destroy(&at);
    __sync_synchronize();
    h->initialized = 1;
  }
  return a;
}

void rt_arena_close(Arena* a) {
  if (!a) return;
  munmap(a->base, a->map_len);
  close(a->fd);
  delete a;
}

// Allocate an object of `size` bytes.  Returns the payload offset
// (page aligned) or 0 on failure.  errno-style result via *err:
//   0 ok, 1 exists (created or sealed), 2 out of memory/ids.
uint64_t rt_create(Arena* a, const char* id, uint64_t size, int* err,
                   uint32_t flags) {
  *err = 2;
  if (!a) return 0;
  if (strlen(id) >= kIdLen) return 0;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return 0;
  Entry* e = find_slot(a, id, h);
  if (!e) {
    unlock(a);
    return 0;  // table full
  }
  if (e->state == kCreated || e->state == kSealed) {
    // Re-create of an existing copy: upgrade to primary if requested —
    // lineage recovery can recompute an object on a node that held a
    // pulled (evictable) copy, and the recomputed object is now the
    // primary.  Never downgrade here.
    if (flags & kFlagPrimary) e->flags |= kFlagPrimary;
    *err = 1;
    unlock(a);
    return 0;
  }
  uint64_t need = page_round(size ? size : 1);
  uint64_t off = alloc_with_eviction(a, need, flags & kFlagWarmOnly);
  if (off == 0) {
    unlock(a);
    return 0;
  }
  memset(e, 0, sizeof(Entry));
  e->hash = h;
  e->state = kCreated;
  e->flags = flags & ~kFlagWarmOnly;
  e->creator_pid = (uint32_t)getpid();
  e->off = off;
  e->size = size;
  e->lru_tick = ++a->hdr->lru_clock;
  strncpy(e->id, id, kIdLen - 1);
  a->hdr->bytes_used += need;
  a->hdr->n_objects++;
  *err = 0;
  unlock(a);
  return off;
}

int rt_seal(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int rc = -1;
  if (e && e->state == kCreated) {
    e->state = kSealed;
    e->lru_tick = ++a->hdr->lru_clock;
    rc = 0;
  } else if (e && e->state == kSealed) {
    rc = 0;
  }
  unlock(a);
  return rc;
}

// Abort an unsealed create (crash cleanup / failed write).
int rt_abort(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int rc = -1;
  if (e && e->state == kCreated) {
    drop_object(a, e);
    rc = 0;
  }
  unlock(a);
  return rc;
}

// Pin + locate a sealed object.  Returns payload offset (0 if absent);
// *size receives the byte size.  Caller must rt_release when done.
uint64_t rt_get(Arena* a, const char* id, uint64_t* size) {
  if (!a) return 0;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return 0;
  Entry* e = find_entry(a, id, h);
  if (!e || e->state != kSealed) {
    unlock(a);
    return 0;
  }
  uint32_t pid = (uint32_t)getpid();
  int free_slot = -1;
  bool pinned_here = false;
  for (uint32_t r = 0; r < kMaxReaders; ++r) {
    if (e->readers[r].count > 0 && e->readers[r].pid == pid) {
      e->readers[r].count++;
      pinned_here = true;
      break;
    }
    if (free_slot < 0 && e->readers[r].count <= 0) free_slot = (int)r;
  }
  if (!pinned_here) {
    if (free_slot < 0) {
      // reader slots exhausted: reclaim slots of dead pids
      for (uint32_t r = 0; r < kMaxReaders; ++r) {
        if (kill((pid_t)e->readers[r].pid, 0) != 0 && errno == ESRCH) {
          free_slot = (int)r;
          break;
        }
      }
    }
    if (free_slot < 0) {
      unlock(a);
      return 0;  // too many concurrent reader processes
    }
    e->readers[free_slot].pid = pid;
    e->readers[free_slot].count = 1;
  }
  e->lru_tick = ++a->hdr->lru_clock;
  *size = e->size;
  uint64_t off = e->off;
  unlock(a);
  return off;
}

int rt_release(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int rc = -1;
  if (e) {
    uint32_t pid = (uint32_t)getpid();
    for (uint32_t r = 0; r < kMaxReaders; ++r) {
      if (e->readers[r].pid == pid && e->readers[r].count > 0) {
        if (--e->readers[r].count == 0) e->readers[r].pid = 0;
        rc = 0;
        break;
      }
    }
  }
  unlock(a);
  return rc;
}

// Delete a sealed object (frees space immediately if unpinned; pinned
// objects are dropped from the table and their extent freed when the
// allocator next needs space and the pins are gone — here we simply skip).
int rt_delete(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int rc = -1;
  if (e && (e->state == kSealed || e->state == kCreated)) {
    if (!pinned(*e)) {
      drop_object(a, e);
      rc = 0;
    } else {
      // demote: stays readable by pinners, invisible to get() latecomers?
      // Simplest correct behavior: keep sealed, let eviction reap it.
      rc = 1;
    }
  }
  unlock(a);
  return rc;
}

// Flags of a live entry, or -1 if absent.
int64_t rt_get_flags(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int64_t rc =
      (e && (e->state == kSealed || e->state == kCreated)) ? e->flags : -1;
  unlock(a);
  return rc;
}

// Set/clear the primary-copy flag (spill manager clears it once the
// object's bytes are safe on disk, making the entry evictable/deletable).
int rt_set_primary(Arena* a, const char* id, int on) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int rc = -1;
  if (e && (e->state == kSealed || e->state == kCreated)) {
    if (on)
      e->flags |= kFlagPrimary;
    else
      e->flags &= ~kFlagPrimary;
    rc = 0;
  }
  unlock(a);
  return rc;
}

// 1 if sealed, 0 otherwise.
int rt_contains(Arena* a, const char* id) {
  if (!a) return 0;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return 0;
  Entry* e = find_entry(a, id, h);
  int rc = (e && e->state == kSealed) ? 1 : 0;
  unlock(a);
  return rc;
}

// Size of a sealed object, or -1.
int64_t rt_size(Arena* a, const char* id) {
  if (!a) return -1;
  uint64_t h = fnv1a(id);
  if (lock(a) != 0) return -1;
  Entry* e = find_entry(a, id, h);
  int64_t rc = (e && e->state == kSealed) ? (int64_t)e->size : -1;
  unlock(a);
  return rc;
}

// Write NUL-separated ids of sealed objects into buf; returns count.
uint64_t rt_list(Arena* a, char* buf, uint64_t buflen) {
  if (!a) return 0;
  if (lock(a) != 0) return 0;
  uint64_t count = 0, w = 0;
  for (uint32_t i = 0; i < a->hdr->n_entries; ++i) {
    Entry& e = a->table[i];
    if (e.state == kSealed) {
      uint64_t n = strlen(e.id) + 1;
      if (w + n > buflen) break;
      memcpy(buf + w, e.id, n);
      w += n;
      count++;
    }
  }
  unlock(a);
  return count;
}

// Plain memcpy exposed for the Python write path: a ctypes foreign call
// RELEASES the GIL, so concurrent putters' payload copies overlap on
// separate cores — a memoryview slice-assign of the same bytes holds the
// GIL for the whole copy and serializes every writer in the process
// (the multi-client put-bandwidth collapse in the r2 bench table).
void rt_memcpy(void* dst, const void* src, uint64_t n) {
  memcpy(dst, src, n);
}

void rt_stats(Arena* a, uint64_t* capacity, uint64_t* used, uint64_t* nobj,
              uint64_t* nevict) {
  if (!a) return;
  if (lock(a) != 0) return;
  *capacity = a->hdr->data_len;
  *used = a->hdr->bytes_used;
  *nobj = a->hdr->n_objects;
  *nevict = a->hdr->n_evictions;
  unlock(a);
}

}  // extern "C"
