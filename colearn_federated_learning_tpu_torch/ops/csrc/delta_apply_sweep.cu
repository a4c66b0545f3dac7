// Other designs of the fused server apply, sm_90a.
//
// Not on any path: tools/delta_apply_sweep.py builds this file and times
// each design against the kernel of server_apply.cu (one float4 a
// thread, a block for every 256 float4s) and torch.add on the same
// buffers, so that the choice made there can be measured again.
// Every design computes what server_apply.cu does, each operation rounded
// once in f32 (bit for bit the plain version):
//
//   no momentum: p' = p + lr * d;   momentum: m' = beta * m - d;
//   p' = p - lr * m'
//
// The designs (`variant`):
//   0  grid stride: blocks_per_sm blocks of 256 threads an SM walk the
//      buffer, one float4 of each input a thread before its store (the
//      first port's kernel, at 8 blocks an SM);
//   1  batched streaming loads: each block takes one contiguous chunk in a
//      one-wave grid of blocks_per_sm blocks an SM; a thread starts
//      kBatch float4 loads of each input (__ldcs, evict-first) before any
//      store (__stcs);
//   2  TMA: each block of a one-wave grid (blocks_per_sm an SM) takes a
//      contiguous run of 2048-float (8 KB) tiles; one thread moves each
//      tile's inputs into a 4-stage shared ring with 1-D bulk copies
//      (cp.async.bulk, completing on an mbarrier), all threads apply it in
//      shared memory, and one thread writes p (and m) back with a bulk
//      copy; a stage is refilled once its store has read it;
//   3  TMA as 2, with 4096-float (16 KB) tiles in a 3-stage ring.
// The N mod tile (variants 2-3) or N mod 4 elements past the last whole
// tile or float4 are done by the last block with scalar code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;

__device__ __forceinline__ float apply_plain(float p, float d, float lr) {
  return __fadd_rn(p, __fmul_rn(lr, d));
}

__device__ __forceinline__ void apply_momentum(float& p, float& m, float d,
                                               float lr, float beta) {
  m = __fsub_rn(__fmul_rn(beta, m), d);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

template <bool kMomentum>
__device__ __forceinline__ void apply4(float4& p, float4& m, const float4& d,
                                       float lr, float beta) {
  if (kMomentum) {
    apply_momentum(p.x, m.x, d.x, lr, beta);
    apply_momentum(p.y, m.y, d.y, lr, beta);
    apply_momentum(p.z, m.z, d.z, lr, beta);
    apply_momentum(p.w, m.w, d.w, lr, beta);
  } else {
    p.x = apply_plain(p.x, d.x, lr);
    p.y = apply_plain(p.y, d.y, lr);
    p.z = apply_plain(p.z, d.z, lr);
    p.w = apply_plain(p.w, d.w, lr);
  }
}

// elements [from, n), by the threads of one block
template <bool kMomentum>
__device__ void scalar_tail(float* p, float* m, const float* d, long long from,
                            long long n, float lr, float beta) {
  for (long long j = from + threadIdx.x; j < n; j += blockDim.x) {
    if (kMomentum) {
      float pj = p[j], mj = m[j];
      apply_momentum(pj, mj, d[j], lr, beta);
      p[j] = pj;
      m[j] = mj;
    } else {
      p[j] = apply_plain(p[j], d[j], lr);
    }
  }
}

template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
grid_stride_kernel(float* __restrict__ p, float* __restrict__ m,
                   const float* __restrict__ d, long long n, float lr,
                   float beta) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * kThreads;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = p4[i];
    float4 mv = kMomentum ? m4[i] : pv;
    apply4<kMomentum>(pv, mv, d4[i], lr, beta);
    p4[i] = pv;
    if (kMomentum) m4[i] = mv;
  }
  if (blockIdx.x == gridDim.x - 1) {
    scalar_tail<kMomentum>(p, m, d, n4 << 2, n, lr, beta);
  }
}

template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
batched_kernel(float* __restrict__ p, float* __restrict__ m,
               const float* __restrict__ d, long long n, float lr,
               float beta) {
  constexpr long long kStep = (long long)kBatch * kThreads;
  const long long n4 = n >> 2;
  const long long steps = (n4 + kStep - 1) / kStep;
  const long long s0 = steps * blockIdx.x / gridDim.x;
  const long long s1 = steps * (blockIdx.x + 1) / gridDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  for (long long st = s0; st < s1; ++st) {
    const long long i0 = st * kStep + threadIdx.x;
    float4 pv[kBatch], mv[kBatch], dv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long i = i0 + b * kThreads;
      if (i < n4) {
        pv[b] = __ldcs(p4 + i);
        dv[b] = __ldcs(d4 + i);
        mv[b] = kMomentum ? __ldcs(m4 + i) : pv[b];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long i = i0 + b * kThreads;
      if (i < n4) {
        apply4<kMomentum>(pv[b], mv[b], dv[b], lr, beta);
        __stcs(p4 + i, pv[b]);
        if (kMomentum) __stcs(m4 + i, mv[b]);
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    scalar_tail<kMomentum>(p, m, d, n4 << 2, n, lr, beta);
  }
}

// ---------------------------------------------------------------------
// TMA: 1-D bulk copies behind mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk store but the newest `N` groups has read its shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// kTile: floats a bulk copy moves; kStages: depth of the ring
template <bool kMomentum, int kTile, int kStages>
constexpr int tma_smem_bytes() {
  return kStages * (kMomentum ? 3 : 2) * kTile * (int)sizeof(float);
}

template <bool kMomentum, int kTile, int kStages>
__global__ void __launch_bounds__(kThreads)
tma_kernel(float* __restrict__ p, float* __restrict__ m,
           const float* __restrict__ d, long long n, float lr, float beta) {
  constexpr int kBufs = kMomentum ? 3 : 2;  // p, d, m
  constexpr uint32_t kBytes = kTile * sizeof(float);
  extern __shared__ __align__(128) float ring[];  // [stage][buf][kTile]
  __shared__ __align__(8) uint64_t full[kStages];
  auto buf = [&](int s, int b) { return ring + (s * kBufs + b) * kTile; };

  const long long tiles = n / kTile;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const int count = (int)(tiles * (blockIdx.x + 1) / gridDim.x - t0);
  auto fetch = [&](int s, long long tile) {
    const long long off = tile * kTile;
    mbar_expect_tx(&full[s], kBufs * kBytes);
    bulk_load(buf(s, 0), p + off, kBytes, &full[s]);
    bulk_load(buf(s, 1), d + off, kBytes, &full[s]);
    if (kMomentum) bulk_load(buf(s, 2), m + off, kBytes, &full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages && s < count; ++s) fetch(s, t0 + s);
  }
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    float4* p4 = reinterpret_cast<float4*>(buf(s, 0));
    const float4* d4 = reinterpret_cast<const float4*>(buf(s, 1));
    float4* m4 = reinterpret_cast<float4*>(buf(s, kBufs - 1));
#pragma unroll
    for (int j = threadIdx.x; j < kTile / 4; j += kThreads) {
      float4 pv = p4[j];
      float4 mv = kMomentum ? m4[j] : pv;
      apply4<kMomentum>(pv, mv, d4[j], lr, beta);
      p4[j] = pv;
      if (kMomentum) m4[j] = mv;
    }
    // the threads' shared writes, before the bulk store reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long off = (t0 + i) * kTile;
      bulk_store(p + off, buf(s, 0), kBytes);
      if (kMomentum) bulk_store(m + off, buf(s, 2), kBytes);
      bulk_commit();
      // refill the stage stored one tile ago, once its store has read it
      if (i >= 1 && i - 1 + kStages < count) {
        bulk_wait_read<1>();
        fetch((i - 1) % kStages, t0 + i - 1 + kStages);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
  if (blockIdx.x == gridDim.x - 1) {
    scalar_tail<kMomentum>(p, m, d, tiles * kTile, n, lr, beta);
  }
}

int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms;
}

template <bool kMomentum, int kTile, int kStages>
int launch_tma(int blocks, float* p, float* m, const float* d, long long n,
               float lr, float beta, cudaStream_t s) {
  constexpr int smem = tma_smem_bytes<kMomentum, kTile, kStages>();
  auto kernel = tma_kernel<kMomentum, kTile, kStages>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kThreads, smem, s>>>(p, m, d, n, lr, beta);
  return (int)cudaGetLastError();
}

template <bool kMomentum>
int launch(int variant, int blocks_per_sm, float* p, const float* d,
           float* m, long long n, float lr, float beta, cudaStream_t s) {
  const long long wave = (long long)sm_count() * blocks_per_sm;
  if (wave > INT_MAX) return (int)cudaErrorInvalidValue;
  float* dd = const_cast<float*>(d);
  switch (variant) {
    case 0:
      grid_stride_kernel<kMomentum><<<(int)wave, kThreads, 0, s>>>(
          p, m, dd, n, lr, beta);
      break;
    case 1:
      batched_kernel<kMomentum><<<(int)wave, kThreads, 0, s>>>(
          p, m, dd, n, lr, beta);
      break;
    case 2:
      return launch_tma<kMomentum, 2048, 4>((int)wave, p, m, dd, n, lr, beta,
                                            s);
    case 3:
      return launch_tma<kMomentum, 4096, 3>((int)wave, p, m, dd, n, lr, beta,
                                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0-3 as above; blocks_per_sm sizes the grid (blocks an SM).
// p, d, m: device pointers to n floats, 16-byte aligned; m may be
// null (no momentum). stream: a cudaStream_t. Returns a cudaError_t.
int colearn_delta_apply_variant(int variant, int blocks_per_sm, float* p,
                                const float* d, float* m, long long n,
                                float lr, float beta, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n <= 0 || blocks_per_sm < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m == nullptr
             ? launch<false>(variant, blocks_per_sm, p, d, m, n, lr, beta, s)
             : launch<true>(variant, blocks_per_sm, p, d, m, n, lr, beta, s);
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
