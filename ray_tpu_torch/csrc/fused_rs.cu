// The fused int8 reduce-scatter hop (K7) for Hopper (sm_90a), over CUDA peer
// memory, plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/quantize.py:316
// _fused_rs_kernel (pallas_call at :387): one kernel per device quantizes
// this device's [world, sub] f32 contributions, writes each peer its int8
// row and f32 scales by remote store, waits for every peer's rows, and sums
// them into f32 [sub].  The arithmetic is K4's with the reciprocal scale
// and K6's in-order FMA chain (csrc/quantize.cu), so the result equals the
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
// Protocol, per CTA b of rank my (CTA b of every rank owns the same blocks
// of the chunk: b, b + G, b + 2G, ..., so it waits only on CTA b of its
// peers and no grid-wide sync is needed):
//   1. wait until every destination's DONE_EPOCH >= epoch - 1: no peer is
//      still reading rows this call overwrites (the TPU kernel's entry
//      barrier, quantize.py:331-340);
//   2. quantize its blocks of every row d and store codes and scales
//      straight into region d, row my;
//   3. __threadfence_system(), then a release store of epoch into
//      ARRIVE[my][b] of every peer region;
//   4. acquire-poll ARRIVE[p][b] >= epoch of its own region for every peer;
//   5. accumulate its blocks over rows 0..world-1 into out;
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
// What bounds it on this card: bytes.  It reads 4*w*sub of input, stores
// w*sub codes and 4*w*sub/block scales (to peers: over NVLink on several
// cards), reads both back, and writes 4*sub; a few operations per byte.
// What the design does about it: each input byte is read once from device
// memory (the block's second pass hits L1/L2); when the block is a
// multiple of 128 inputs are read as float4, codes leave as 4-byte stores
// and the accumulate reads char4 and writes float4; nothing goes through
// an intermediate buffer.  TMA / bulk copies to peers and multimem stores are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORLD = 16;
constexpr int MAX_CTAS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float RECIP_127 = 1.0f / 127.0f;  // IEEE-rounded, as XLA folds it

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

// max that keeps NaN, as torch.amax / jnp.max do (fmaxf drops it)
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// K4's rounding: clip(rint(x * inv)) to [-127, 127], NaN -> 0
__device__ __forceinline__ signed char code_of(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = (r != r) ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
  return (signed char)(int)r;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_rs_kernel(const float* __restrict__ x, long long rank_stride,
                long long row_stride, int sub, int block, int world, int my0,
                char* const* __restrict__ table, long long scales_off,
                unsigned epoch, float post_scale, float* __restrict__ out,
                long long out_rank_stride, int* err,
                unsigned long long timeout_ns) {
  __shared__ int s_ok;
  const int my = my0 + blockIdx.y;
  const float* xr = x + blockIdx.y * rank_stride;
  float* outr = out + blockIdx.y * out_rank_stride;
  const int b = blockIdx.x, G = gridDim.x;
  const int nblk = sub / block;
  const int owned = nblk > b ? (nblk - b + G - 1) / G : 0;
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

  // 2. quantize row d's owned blocks straight into region d, row my: one
  //    warp per (destination, block)
  const int pairs = world * owned;
  for (int t = warp; t < pairs; t += WARPS) {
    const int d = t % world;
    const int j = b + (t / world) * G;
    const float* src = xr + d * row_stride + (long long)j * block;
    float m = 0.f;
    if (VEC) {
      for (int i = lane * 4; i < block; i += 128) {
        const float4 v = *reinterpret_cast<const float4*>(src + i);
        m = nan_max(m, fabsf(v.x));
        m = nan_max(m, fabsf(v.y));
        m = nan_max(m, fabsf(v.z));
        m = nan_max(m, fabsf(v.w));
      }
    } else {
      for (int i = lane; i < block; i += 32) m = nan_max(m, fabsf(src[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(FULL, m, off));
    const float scale = m > 0.f ? __fmul_rn(m, RECIP_127) : 1.f;
    const float inv = __frcp_rn(scale);
    signed char* dq = (signed char*)(table[d] + DATA_OFF) +
                      (long long)my * sub + (long long)j * block;
    if (VEC) {
      for (int i = lane * 4; i < block; i += 128) {
        const float4 v = *reinterpret_cast<const float4*>(src + i);
        *reinterpret_cast<char4*>(dq + i) =
            make_char4(code_of(v.x, inv), code_of(v.y, inv),
                       code_of(v.z, inv), code_of(v.w, inv));
      }
    } else {
      for (int i = lane; i < block; i += 32) dq[i] = code_of(src[i], inv);
    }
    if (lane == 0)
      ((float*)(table[d] + scales_off))[(long long)my * nblk + j] = scale;
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
  const signed char* rq = (const signed char*)(mine + DATA_OFF);
  const float* rs = (const float*)(mine + scales_off);
  if (VEC) {
    // four elements a thread: char4 loads, a float4 store (rows and the
    // output are 4-element aligned: sub and block are multiples of 128)
    const int q4 = block >> 2;
    const int items = owned * q4;
    for (int t = tid; t < items; t += THREADS) {
      const int k = t / q4;
      const int j = b + k * G;
      const long long e = (long long)j * block + (long long)(t - k * q4) * 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int p = 0; p < world; ++p) {
        const char4 c =
            __ldcg(reinterpret_cast<const char4*>(rq + (long long)p * sub + e));
        const float s = __ldcg(rs + (long long)p * nblk + j);
        a0 = __fmaf_rn((float)c.x, s, a0);
        a1 = __fmaf_rn((float)c.y, s, a1);
        a2 = __fmaf_rn((float)c.z, s, a2);
        a3 = __fmaf_rn((float)c.w, s, a3);
      }
      *reinterpret_cast<float4*>(outr + e) =
          make_float4(__fmul_rn(a0, post_scale), __fmul_rn(a1, post_scale),
                      __fmul_rn(a2, post_scale), __fmul_rn(a3, post_scale));
    }
  } else {
    const int span = owned * block;
    for (int t = tid; t < span; t += THREADS) {
      const int k = t / block;
      const int j = b + k * G;
      const long long e = (long long)j * block + (t - k * block);
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
  const bool vec = block % 128 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   row_stride % 4 == 0 && rank_stride % 4 == 0;
  void* fn = vec ? (void*)fused_rs_kernel<true> : (void*)fused_rs_kernel<false>;
  const float* xf = static_cast<const float*>(x);
  char* const* tb = static_cast<char* const*>(table);
  float* of = static_cast<float*>(out);
  int* ep = static_cast<int*>(err);
  void* args[] = {(void*)&xf,         (void*)&rank_stride, (void*)&row_stride,
                  (void*)&sub,        (void*)&block,       (void*)&world,
                  (void*)&my0,        (void*)&tb,          (void*)&scales_off,
                  (void*)&epoch,      (void*)&post_scale,  (void*)&of,
                  (void*)&out_rank_stride, (void*)&ep,     (void*)&timeout_ns};
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
// the smaller of the two instantiations) and its SM count.
int rtt_fused_rs_residency(int* resident, int* sms) {
  int dev = 0, a = 0, c = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a, fused_rs_kernel<true>, THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &c, fused_rs_kernel<false>, THREADS, 0);
  *resident = (a < c ? a : c) * *sms;
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
