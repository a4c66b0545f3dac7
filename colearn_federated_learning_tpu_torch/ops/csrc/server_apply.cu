// Fused server apply for the flat f32 parameter buffer, sm_90a.
//
// Replaces the TPU kernel `_delta_apply_kernel`, reached through
// `fused_delta_apply` in colearn_federated_learning_tpu/ops/pallas_apply.py
// (no-momentum call at :222, momentum call at :209). Same arithmetic,
// each operation rounded once in f32 as the Pallas kernel's jnp ops are:
//
//   no momentum (server.optimizer=mean):  p' = p + lr * d
//   momentum    (server.optimizer=fedavgm): m' = beta * m - d;  p' = p - lr * m'
//
// d is the example-weighted mean client delta. Both updates are in place.
//
// Bound on an H100 SXM (3.35 TB/s): the pass is memory-bound — 2 flops
// per 12 bytes without momentum (read d, read p, write p) and 4 flops per
// 20 bytes with it. For ResNet-18 (N = 11,173,962) that is 134 MB, ~40 us,
// and 223 MB, ~67 us. No byte is read twice and nothing is staged
// through shared memory. Every thread loads one float4 of each input and
// stores its result, and the grid has a block for every kThreads float4s
// (10,913 at ResNet-18's N), so the block scheduler, not the kernel,
// shares out the work. This is the plainest form and it measured the
// fastest on an H100 80GB HBM3 at 700 W, level with torch.add at 84 % of
// the mean branch's bound (tools/delta_apply_sweep.py, which builds the
// other designs from delta_apply_sweep.cu; PERF.md): the first port's
// grid-stride loop over 8 resident blocks an SM; 4 float4 loads of each
// input a thread before any store, with evict-first hints (__ldcs/__stcs),
// one contiguous chunk a block in a one-wave grid; and 1-D TMA bulk
// copies through a shared ring were all slower. A scalar tail handles
// N mod 4. The TPU kernel's [G*64, 128] tiling and the flatten/pad around
// it are TPU layout choices and are not carried over: the port keeps the
// parameters in one flat buffer already.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float apply_plain(float p, float d, float lr) {
  return __fadd_rn(p, __fmul_rn(lr, d));
}

__device__ __forceinline__ void apply_momentum(float& p, float& m, float d,
                                               float lr, float beta) {
  m = __fsub_rn(__fmul_rn(beta, m), d);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

// Thread i owns float4 i; the last block also takes the scalar tail.
__global__ void __launch_bounds__(kThreads)
delta_apply_kernel(float* __restrict__ p, const float* __restrict__ d,
                   long long n, float lr) {
  const long long n4 = n >> 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    float4* p4 = reinterpret_cast<float4*>(p);
    float4 pv = p4[i];
    const float4 dv = reinterpret_cast<const float4*>(d)[i];
    pv.x = apply_plain(pv.x, dv.x, lr);
    pv.y = apply_plain(pv.y, dv.y, lr);
    pv.z = apply_plain(pv.z, dv.z, lr);
    pv.w = apply_plain(pv.w, dv.w, lr);
    p4[i] = pv;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < (n & 3)) {
    const long long j = (n4 << 2) + threadIdx.x;
    p[j] = apply_plain(p[j], d[j], lr);
  }
}

__global__ void __launch_bounds__(kThreads)
delta_apply_momentum_kernel(float* __restrict__ p, float* __restrict__ m,
                            const float* __restrict__ d, long long n,
                            float lr, float beta) {
  const long long n4 = n >> 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4 pv = p4[i];
    float4 mv = m4[i];
    const float4 dv = reinterpret_cast<const float4*>(d)[i];
    apply_momentum(pv.x, mv.x, dv.x, lr, beta);
    apply_momentum(pv.y, mv.y, dv.y, lr, beta);
    apply_momentum(pv.z, mv.z, dv.z, lr, beta);
    apply_momentum(pv.w, mv.w, dv.w, lr, beta);
    p4[i] = pv;
    m4[i] = mv;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < (n & 3)) {
    const long long j = (n4 << 2) + threadIdx.x;
    float pj = p[j];
    float mj = m[j];
    apply_momentum(pj, mj, d[j], lr, beta);
    p[j] = pj;
    m[j] = mj;
  }
}

// a block for every kThreads float4s; n < 4 takes one block for the tail
long long grid_for(long long n) {
  const long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" {

// p, d, m: device pointers to n floats, 16-byte aligned; m may be null
// (no momentum). stream: a cudaStream_t. Returns a cudaError_t.
int colearn_delta_apply(float* p, const float* d, float* m, long long n,
                        float lr, float beta, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = grid_for(n);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (m == nullptr) {
    delta_apply_kernel<<<(int)blocks, kThreads, 0, s>>>(p, d, n, lr);
  } else {
    delta_apply_momentum_kernel<<<(int)blocks, kThreads, 0, s>>>(p, m, d, n,
                                                                 lr, beta);
  }
  return (int)cudaGetLastError();
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
