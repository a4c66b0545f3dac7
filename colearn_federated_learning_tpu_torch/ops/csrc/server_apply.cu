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
// and 223 MB, ~67 us. The design does the least that reaches the bound:
// every thread moves 16-byte float4 vectors in a grid-stride loop (a few
// waves of blocks per SM keep enough loads in flight), a scalar tail
// handles N mod 4, and nothing is staged through shared memory because
// no element is read twice. The TPU kernel's [G*64, 128] tiling and the
// flatten/pad around it are TPU layout choices and are not carried over:
// the port keeps the parameters in one flat buffer already.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float apply_plain(float p, float d, float lr) {
  return __fadd_rn(p, __fmul_rn(lr, d));
}

__device__ __forceinline__ void apply_momentum(float& p, float& m, float d,
                                               float lr, float beta) {
  m = __fsub_rn(__fmul_rn(beta, m), d);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

__global__ void __launch_bounds__(kThreads)
delta_apply_kernel(float* __restrict__ p, const float* __restrict__ d,
                   long long n, float lr) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  for (long long i = start; i < n4; i += stride) {
    float4 pv = p4[i];
    const float4 dv = d4[i];
    pv.x = apply_plain(pv.x, dv.x, lr);
    pv.y = apply_plain(pv.y, dv.y, lr);
    pv.z = apply_plain(pv.z, dv.z, lr);
    pv.w = apply_plain(pv.w, dv.w, lr);
    p4[i] = pv;
  }
  for (long long i = (n4 << 2) + start; i < n; i += stride) {
    p[i] = apply_plain(p[i], d[i], lr);
  }
}

__global__ void __launch_bounds__(kThreads)
delta_apply_momentum_kernel(float* __restrict__ p, float* __restrict__ m,
                            const float* __restrict__ d, long long n,
                            float lr, float beta) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* d4 = reinterpret_cast<const float4*>(d);
  for (long long i = start; i < n4; i += stride) {
    float4 pv = p4[i];
    float4 mv = m4[i];
    const float4 dv = d4[i];
    apply_momentum(pv.x, mv.x, dv.x, lr, beta);
    apply_momentum(pv.y, mv.y, dv.y, lr, beta);
    apply_momentum(pv.z, mv.z, dv.z, lr, beta);
    apply_momentum(pv.w, mv.w, dv.w, lr, beta);
    p4[i] = pv;
    m4[i] = mv;
  }
  for (long long i = (n4 << 2) + start; i < n; i += stride) {
    float pi = p[i];
    float mi = m[i];
    apply_momentum(pi, mi, d[i], lr, beta);
    p[i] = pi;
    m[i] = mi;
  }
}

int grid_for(long long n) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int device = 0;
    int sms = 132;
    if (cudaGetDevice(&device) == cudaSuccess) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    max_blocks = sms * kBlocksPerSm;
  }
  long long work = (n + 3) >> 2;  // float4 slots, the tail rides along
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : (int)blocks;
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
  const int blocks = grid_for(n);
  if (m == nullptr) {
    delta_apply_kernel<<<blocks, kThreads, 0, s>>>(p, d, n, lr);
  } else {
    delta_apply_momentum_kernel<<<blocks, kThreads, 0, s>>>(p, m, d, n, lr,
                                                            beta);
  }
  return (int)cudaGetLastError();
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
