// The fused int8 reduce-scatter hop (K7) for Hopper (sm_90a), over CUDA peer
// memory, plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/quantize.py:316
// _fused_rs_kernel (pallas_call at :387): one kernel per device quantizes
// this device's [world, sub] f32 contributions, writes each peer its int8
// row and f32 scales by remote store, waits for every peer's rows, and sums
// them into f32 [sub].  The arithmetic is K4's with the reciprocal scale
// and K6's in-order FMA chain, from the warp tiles of csrc/quant_tile.cuh
// that K4 and K6 (csrc/quantize.cu) run too, so the result equals the
// staged path K4 -> all_to_all -> K6 bit for bit:
//   scale = absmax * f32(1/127) (1.0 when absmax > 0 fails: an all-zero
//   block, or a NaN in the block), q = clip(rint(x * (1 / scale))) with a
//   NaN code 0 (XLA's float -> int8 conversion), acc = fma(q[p], s[p], acc)
//   over peers 0..world-1 from an f32 zero, then times post_scale (1.0, or
//   the mean's f32(1/world)).
//
// Peer memory.  Every rank owns one receive region (cudaMalloc'd by the
// host, zeroed once, exported with cudaIpcGetMemHandle and mapped by its
// peers with cudaIpcOpenMemHandle).  The kernel gets the table of the world
// regions' base pointers.  A region holds, from its base:
//   ARRIVE_OFF      u32 [MAX_WORLD][MAX_CTAS]: sender s's CTA b wrote its
//                   rows for epoch e (the flag holds e);
//   DONE_CTR_OFF    u32: CTAs of this rank done with the current epoch;
//   DONE_EPOCH_OFF  u32: the last epoch every CTA of this rank finished
//                   reading;
//   DATA_OFF        int8 [world][sub] codes, row s = sender s (the
//                   reference's "remote row index = sender id");
//   scales_off      f32 [world][sub / block] scales, row s = sender s.
// Epochs are a per-group call counter, the same on every rank because
// every rank issues the same calls in the same order; flags only rise, so
// nothing is ever reset between calls (the host zeroes a region only when
// it allocates it, and restarts the epoch at 1 then).
//
// Protocol, per CTA b of rank my (CTA b of every rank owns the same units
// of the chunk: b, b + G, b + 2G, ..., a unit being a 512-element tile of
// every row, or a single block: the ragged tail under a tile, or every
// block where the tiles do not apply; the units depend on sub and block
// alone, the same on every rank, so CTA b waits only on CTA b of its
// peers and no grid-wide sync is needed):
//   1. wait until every destination's DONE_EPOCH >= epoch - 1: no peer is
//      still reading rows this call overwrites (the TPU kernel's entry
//      barrier, quantize.py:331-340);
//   2. quantize its units of every row d and store codes and scales
//      straight into region d, row my;
//   3. __threadfence_system(), then a release store of epoch into
//      ARRIVE[my][b] of every peer region;
//   4. acquire-poll ARRIVE[p][b] >= epoch of its own region for every peer;
//   5. accumulate its units over rows 0..world-1 into out;
//   6. count itself done; the last CTA of the rank publishes DONE_EPOCH.
// Every spin is bounded by timeout_ns of %globaltimer: past it the CTA
// writes an error code to a host-mapped word and exits, so a peer that
// never arrives fails the call (the wrapper raises) instead of hanging.
//
// Launch modes: one launch per rank (multi-process, peers' regions
// IPC-mapped; the grid is kept at most one CTA per SM, so every spinning
// CTA is co-resident with its peers' and with NCCL's kernels), or one
// cooperative launch hosting nranks ranks on one card (gridDim.y = rank
// offset; loopback, a test harness for the protocol on one card).
//
// What bounds it on this card: bytes.  It reads 4 w sub of input, stores
// w sub codes and 4 w sub / block scales (to peers: over NVLink at 450 GB/s
// each way on several cards, where the link bounds it before HBM does),
// reads both back, and writes 4 sub; a few operations per byte.  At the dp
// step's chunks (1.2-4.8M elements, 3.6-14.5 us of HBM bound at world 1)
// the launch ramp and the protocol's fences and flags add a few us.  The
// first version ran 256 threads per CTA at one CTA per SM (8 warps, one or
// two 16-byte loads per lane in flight: 4-8 KB per SM against the ~16 KB
// Little's law asks), read every block twice and stored codes as 4-byte
// words, accumulated from 4-byte code loads.  The design:
//   - 512 threads per CTA (16 warps), still at most one CTA per SM in a
//     group (co-residency with the peers' CTAs and NCCL's kernels);
//   - stage 2 is K4's quantize tile: four 16-byte loads per lane, each
//     input byte read once; a warp issues its next tile's loads before
//     this tile's arithmetic (64 KB in flight per SM: a CTA per SM leaves
//     registers for it); the codes cross lanes through 512 bytes of shared
//     memory per warp so that they leave as 16-byte stores (a warp's 512
//     codes contiguous), the scales as one coalesced store per warp;
//   - stage 5 is K6's accumulate tile: per peer one 16-byte __ldcg of
//     codes per lane (L2: the rows were written by other SMs or cards),
//     every peer's loads before the in-order FMA chain, 16-byte stores of
//     512 contiguous bytes an instruction.
// Inputs the tiles cannot take (a block that is not a power of two from 16
// to 512; x, a row or out not 16-byte aligned) and the ragged tail under a
// tile (sub % 512) run the per-element body in the same launch, with the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace qtile;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORLD = 16;
constexpr int MAX_CTAS = 1024;

constexpr long long ARRIVE_OFF = 0;
constexpr long long DONE_CTR_OFF = (long long)MAX_WORLD * MAX_CTAS * 4;
constexpr long long DONE_EPOCH_OFF = DONE_CTR_OFF + 4;
constexpr long long DATA_OFF = DONE_CTR_OFF + 256;

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// spin until *p >= e (epochs compared modulo 2^32); false past deadline,
// with `code` written to the host-mapped error word
__device__ bool wait_epoch(const unsigned* p, unsigned e,
                           unsigned long long deadline, volatile int* err,
                           int code) {
  while ((int)(ld_acquire_sys(p) - e) < 0) {
    if (now_ns() > deadline) {
      *err = code;
      __threadfence_system();
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

// MAXW: peers whose loads stage 5 issues together (1, 2, 4 or 8; a larger
// world takes them MAXW at a time).  Ownership: units 0..tiles-1 are the
// 512-element tiles of every row, the units after them single blocks (the
// ragged tail under a tile, or every block when tiles == 0).  VEC: the
// tiles run on the warp tiles of quant_tile.cuh; otherwise (and always for
// the tail) the per-element body, with the same bits.
template <int MAXW, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
fused_rs_kernel(const float* __restrict__ x, long long rank_stride,
                long long row_stride, int sub, int block, int world, int my0,
                char* const* __restrict__ table, long long scales_off,
                unsigned epoch, float post_scale, float* __restrict__ out,
                long long out_rank_stride, int* err,
                unsigned long long timeout_ns, int tiles) {
  __shared__ int s_ok;
  __shared__ __align__(16) uint32_t stage[VEC ? WARPS : 1][TILE / 4];
  const int my = my0 + blockIdx.y;
  const float* xr = x + blockIdx.y * rank_stride;
  float* outr = out + blockIdx.y * out_rank_stride;
  const int b = blockIdx.x, G = gridDim.x;
  const int nblk = sub / block;
  const int tile_blocks = TILE / block;
  const int nunits = tiles + (sub - tiles * TILE) / block;
  const int owned_tiles = tiles > b ? (tiles - b + G - 1) / G : 0;
  // the first unit of this CTA that the per-element body takes
  const int u_elem = VEC ? b + owned_tiles * G : b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  char* const mine = table[my];
  volatile int* verr = err;
  const unsigned long long deadline = now_ns() + timeout_ns;

  // 1. no destination still reads the rows this epoch overwrites
  if (tid == 0) {
    int ok = 1;
    for (int d = 0; d < world && ok; ++d)
      ok = wait_epoch((const unsigned*)(table[d] + DONE_EPOCH_OFF),
                      epoch - 1u, deadline, verr, 1);
    s_ok = ok;
  }
  __syncthreads();
  if (!s_ok) return;

  // 2. quantize row d's owned units straight into region d, row my
  if (VEC) {
    // one warp per pair t (destination t % world, tile b + (t / world) G):
    // K4's quantize tile, codes out as 16-byte stores; the next pair's
    // loads are issued before this one's arithmetic
    const int pairs = world * owned_tiles;
    auto load_pair = [&](int t, float (&v)[4][4]) {
      const float* src =
          xr + (t % world) * row_stride + (b + (t / world) * G) * TILE;
#pragma unroll
      for (int k = 0; k < 4; ++k) load16(src + 128 * k + 4 * lane, v[k]);
    };
    float v[4][4], nv[4][4];
    if (warp < pairs) load_pair(warp, v);
    for (int t = warp; t < pairs; t += WARPS) {
      const int d = t % world;
      const int i0 = (b + (t / world) * G) * TILE;
      if (t + WARPS < pairs) load_pair(t + WARPS, nv);
      float s[4];
      uint32_t w[4][1];
      quantize_tile<4, false>(v, block, 1, 0u, 0u, s, w);
      const int4 c = codes_to_runs(stage[warp], lane, w);
      signed char* dq =
          (signed char*)(table[d] + DATA_OFF) + (long long)my * sub + i0;
      reinterpret_cast<int4*>(dq)[lane] = c;
      store_tile_scales<4>((float*)(table[d] + scales_off) +
                               (long long)my * nblk + i0 / block,
                           s, block, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = nv[k][j];
    }
  }
  // the per-element body: one warp per (destination, block) of a unit,
  // the block read twice (the second pass from L1/L2)
  for (int u = u_elem; u < nunits; u += G) {
    const int j0 =
        u < tiles ? u * tile_blocks : tiles * tile_blocks + (u - tiles);
    const int items = world * (u < tiles ? tile_blocks : 1);
    for (int t = warp; t < items; t += WARPS) {
      const int d = t % world;
      const int j = j0 + t / world;
      const float* src = xr + d * row_stride + (long long)j * block;
      float m = 0.f;
      for (int i = lane; i < block; i += 32) m = nan_max(m, fabsf(src[i]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_xor_sync(FULL, m, off));
      const float scale = scale_of(m, 1);
      const float inv = __frcp_rn(scale);
      signed char* dq = (signed char*)(table[d] + DATA_OFF) +
                        (long long)my * sub + (long long)j * block;
      for (int i = lane; i < block; i += 32)
        dq[i] = (signed char)code_of<false>(src[i], inv, 0u, 0u);
      if (lane == 0)
        ((float*)(table[d] + scales_off))[(long long)my * nblk + j] = scale;
    }
  }

  // 3. the rows are visible system-wide before any flag that names them
  __threadfence_system();
  __syncthreads();
  if (tid == 0) {
    for (int o = 1; o < world; ++o) {
      const int d = (my + o) % world;
      st_release_sys((unsigned*)(table[d] + ARRIVE_OFF) + my * MAX_CTAS + b,
                     epoch);
    }
  }

  // 4. every peer's CTA b has written its rows into this region
  if (tid == 0) {
    int ok = 1;
    const unsigned* arrive = (const unsigned*)(mine + ARRIVE_OFF);
    for (int p = 0; p < world && ok; ++p)
      if (p != my)
        ok = wait_epoch(arrive + p * MAX_CTAS + b, epoch, deadline, verr, 2);
    __threadfence();
    s_ok = ok;
  }
  __syncthreads();
  if (!s_ok) return;

  // 5. in-order FMA over peers; L1 is bypassed (__ldcg), the rows were
  //    written by other SMs and other cards
  const int8_t* rq = (const int8_t*)(mine + DATA_OFF);
  const float* rs = (const float*)(mine + scales_off);
  if (VEC) {
    // one warp per tile: K6's accumulate tile
    const int shift = block_shift(block);
    for (int k = warp; k < owned_tiles; k += WARPS)
      accum_tile<MAXW, true, true>(rq, sub, rs, nblk, world,
                                   (b + k * G) * TILE, block, shift,
                                   post_scale, stage[warp], lane, outr);
  }
  for (int u = u_elem; u < nunits; u += G) {
    const long long e0 = u < tiles ? (long long)u * TILE
                                   : (long long)tiles * TILE +
                                         (long long)(u - tiles) * block;
    const int len = u < tiles ? TILE : block;
    for (int t = tid; t < len; t += THREADS) {
      const long long e = e0 + t;
      const int j = (int)(e / block);
      float acc = 0.f;
      for (int p = 0; p < world; ++p)
        acc = __fmaf_rn((float)__ldcg(rq + (long long)p * sub + e),
                        __ldcg(rs + (long long)p * nblk + j), acc);
      outr[e] = __fmul_rn(acc, post_scale);  // 1.0 for a sum: exact
    }
  }

  // 6. this rank's last CTA to finish reading publishes the epoch
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    unsigned* ctr = (unsigned*)(mine + DONE_CTR_OFF);
    if (atomicAdd(ctr, 1u) == (unsigned)G - 1u) {
      __threadfence();
      *ctr = 0u;  // the next launch on this stream starts after this one
      st_release_sys((unsigned*)(mine + DONE_EPOCH_OFF), epoch);
    }
  }
}

// The whole 512-element tiles of a row that K7 owns as units: every tile
// when the block is a power of two from 16 to 512, else none (every unit a
// block).  It depends on sub and block alone, so every rank of a group
// agrees on the ownership (ops/_kernels.py's fused_rs_units states the
// same rule).
int tiles_of(int sub, int block) {
  return block >= 16 && block <= TILE && block_shift(block) >= 0
             ? sub / TILE
             : 0;
}

// The instance for world (MAXW) and the body of the tiles; every instance
// of one call owns the same units.
void* kernel_for(int world, bool vec) {
  if (!vec) return (void*)fused_rs_kernel<1, false>;
  return world == 1   ? (void*)fused_rs_kernel<1, true>
         : world <= 2 ? (void*)fused_rs_kernel<2, true>
         : world <= 4 ? (void*)fused_rs_kernel<4, true>
                      : (void*)fused_rs_kernel<8, true>;
}

}  // namespace

extern "C" {

// x: nranks ranks' [world, sub] f32 inputs, rank r at x + r * rank_stride,
// row d at + d * row_stride (unit column stride); out: nranks [sub] f32
// rows, out_rank_stride apart.  table: device array of the world regions'
// base pointers.  my0: rank of the first hosted rank.  cooperative: 1 for
// the one-card loopback launch.  Returns the launch's cudaError_t.
int rtt_fused_rs(const void* x, long long rank_stride, long long row_stride,
                 int sub, int block, int world, int my0, int nranks,
                 const void* table, long long scales_off, unsigned int epoch,
                 float post_scale, void* out, long long out_rank_stride,
                 void* err, unsigned long long timeout_ns, int grid,
                 int cooperative, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > MAX_WORLD || block < 1 || block > 4096 ||
      sub < block || sub % block || grid < 1 || grid > MAX_CTAS ||
      grid > sub / block || nranks < 1 || my0 < 0 || my0 + nranks > world ||
      scales_off < DATA_OFF + (long long)world * sub)
    return (int)cudaErrorInvalidValue;
  const int tiles = tiles_of(sub, block);
  const bool vec = tiles > 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   row_stride % 4 == 0 && rank_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   out_rank_stride % 4 == 0;
  void* fn = kernel_for(world, vec);
  const float* xf = static_cast<const float*>(x);
  char* const* tb = static_cast<char* const*>(table);
  float* of = static_cast<float*>(out);
  int* ep = static_cast<int*>(err);
  void* args[] = {(void*)&xf,         (void*)&rank_stride, (void*)&row_stride,
                  (void*)&sub,        (void*)&block,       (void*)&world,
                  (void*)&my0,        (void*)&tb,          (void*)&scales_off,
                  (void*)&epoch,      (void*)&post_scale,  (void*)&of,
                  (void*)&out_rank_stride, (void*)&ep,     (void*)&timeout_ns,
                  (void*)&tiles};
  const dim3 g(grid, nranks), b(THREADS);
  cudaError_t e = cooperative
                      ? cudaLaunchCooperativeKernel(fn, g, b, args, 0, st)
                      : cudaLaunchKernel(fn, g, b, args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The layout constants the host sizes regions by.
int rtt_fused_rs_layout(long long* data_off, int* max_world, int* max_ctas) {
  *data_off = DATA_OFF;
  *max_world = MAX_WORLD;
  *max_ctas = MAX_CTAS;
  return 0;
}

// CTAs of the kernel co-resident on the current device (SMs x occupancy,
// the smallest over its instances) and its SM count.
int rtt_fused_rs_residency(int* resident, int* sms) {
  int dev = 0, least = 1 << 30;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fns[] = {kernel_for(1, true), kernel_for(2, true),
                       kernel_for(4, true), kernel_for(8, true),
                       kernel_for(1, false)};
  for (const void* fn : fns) {
    int a = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, fn, THREADS, 0);
    least = a < least ? a : least;
  }
  *resident = least * *sms;
  return (int)e;
}

// A zeroed receive region on the current device; returns once it is zero.
int rtt_peer_alloc(long long bytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

int rtt_peer_free(void* ptr) { return (int)cudaFree(ptr); }

// 64-byte IPC handle of a region allocated by rtt_peer_alloc.
int rtt_ipc_get_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) *static_cast<cudaIpcMemHandle_t*>(handle) = h;
  return (int)e;
}

int rtt_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int rtt_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int rtt_can_access_peer(int dev, int peer, int* ok) {
  return (int)cudaDeviceCanAccessPeer(ok, dev, peer);
}

// A zeroed int in mapped, portable pinned host memory: the kernel's error
// word, readable by the host without a synchronize.
int rtt_host_word(void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, 64, cudaHostAllocMapped |
                                              cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  *static_cast<volatile int*>(*host) = 0;
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

int rtt_host_free(void* host) { return (int)cudaFreeHost(host); }

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
