// Fused reduce + server apply over a [K, N] f32 upload stack, sm_90a.
//
// Replaces the TPU kernel `_reduce_apply_kernel`, reached through
// `fused_reduce_apply` in colearn_federated_learning_tpu/ops/pallas_apply.py
// (momentum call at :262, no-momentum call at :275). Same arithmetic,
// each operation rounded once in f32:
//
//   d = sum_k w[k] * S[k]          (rows in order 0..K-1, from d = 0)
//   no momentum (server.optimizer=mean):    p' = p + lr * d
//   momentum    (server.optimizer=fedavgm): m' = beta * m - d;  p' = p - lr * m'
//
// The weights arrive pre-folded (FedAvg weight / weight sum, or Krum's
// one-hot winner row times (m > 0)), so d is the finished aggregate. p and
// m are updated in place; d is written out, as the TPU kernel's third
// output is.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Each element reads K stack
// values, p (and m) and writes p (and m) and d: (K+3)*4 bytes for 2K+2
// flops without momentum, (K+5)*4 bytes for 2K+4 flops with it. For the
// ResNet-18 cohort (K = 16, N = 11,173,962) that is 849 MB, ~0.254 ms,
// and 939 MB, ~0.280 ms. The design does the least that reaches the
// bound: each thread owns float4 columns in a grid-stride loop and walks
// the K rows in order (independent loads, unrolled so several are in
// flight), the K weights sit in shared memory, and nothing else is staged
// because no stack element is read twice. Rows lie `ld` floats apart; the
// wrapper requires ld % 4 == 0 and 16-byte-aligned bases, so every row's
// float4 loads are aligned (a dense [K, N] stack with N % 4 != 0 is not).
// A scalar tail handles N mod 4. Like the TPU kernel it reads every row,
// also those whose weight is 0 (Krum's one-hot row): skipping them is a
// later speed item. The TPU kernel's [K, G*8, 128] tiling and the
// flatten/pad around it are TPU layout choices and are not carried over.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxRows = 12288;  // the weights fill at most 48 KB of shared

__device__ __forceinline__ float axpy_rn(float acc, float w, float s) {
  return __fadd_rn(acc, __fmul_rn(w, s));
}

template <bool kMomentum>
__device__ __forceinline__ void apply(float& p, float& m, float d, float lr,
                                      float beta) {
  if constexpr (kMomentum) {
    m = __fsub_rn(__fmul_rn(beta, m), d);
    p = __fsub_rn(p, __fmul_rn(lr, m));
  } else {
    p = __fadd_rn(p, __fmul_rn(lr, d));
  }
}

template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
reduce_apply_kernel(const float* __restrict__ stack, long long ld, int k,
                    const float* __restrict__ w, float* __restrict__ p,
                    float* __restrict__ m, float* __restrict__ d,
                    long long n, float lr, float beta) {
  extern __shared__ float ws[];
  for (int r = threadIdx.x; r < k; r += blockDim.x) ws[r] = w[r];
  __syncthreads();

  const long long n4 = n >> 2;
  const long long ld4 = ld >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* s4 = reinterpret_cast<const float4*>(stack);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* d4 = reinterpret_cast<float4*>(d);
  for (long long i = start; i < n4; i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* col = s4 + i;
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      const float4 v = __ldg(col + (long long)r * ld4);
      const float wr = ws[r];
      acc.x = axpy_rn(acc.x, wr, v.x);
      acc.y = axpy_rn(acc.y, wr, v.y);
      acc.z = axpy_rn(acc.z, wr, v.z);
      acc.w = axpy_rn(acc.w, wr, v.w);
    }
    d4[i] = acc;
    float4 pv = p4[i];
    float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kMomentum) mv = m4[i];
    apply<kMomentum>(pv.x, mv.x, acc.x, lr, beta);
    apply<kMomentum>(pv.y, mv.y, acc.y, lr, beta);
    apply<kMomentum>(pv.z, mv.z, acc.z, lr, beta);
    apply<kMomentum>(pv.w, mv.w, acc.w, lr, beta);
    p4[i] = pv;
    if constexpr (kMomentum) m4[i] = mv;
  }
  for (long long i = (n4 << 2) + start; i < n; i += stride) {
    float acc = 0.f;
    for (int r = 0; r < k; ++r) {
      acc = axpy_rn(acc, ws[r], stack[(long long)r * ld + i]);
    }
    d[i] = acc;
    float pi = p[i];
    float mi = 0.f;
    if constexpr (kMomentum) mi = m[i];
    apply<kMomentum>(pi, mi, acc, lr, beta);
    p[i] = pi;
    if constexpr (kMomentum) m[i] = mi;
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
  long long work = (n + 3) >> 2;  // float4 columns, the tail rides along
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// stack: device pointer to k rows of n floats, row r at stack + r * ld;
// w: k floats on the device; p, d (and m): n floats. Every pointer
// 16-byte aligned and ld % 4 == 0. m may be null (no momentum). stream: a
// cudaStream_t. Returns a cudaError_t.
int colearn_reduce_apply(const float* stack, long long ld, int k,
                         const float* w, float* p, float* m, float* d,
                         long long n, float lr, float beta, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (n <= 0 || k <= 0 || k > kMaxRows || ld < n || (ld & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  const size_t smem = (size_t)k * sizeof(float);
  if (m == nullptr) {
    reduce_apply_kernel<false><<<blocks, kThreads, smem, s>>>(
        stack, ld, k, w, p, m, d, n, lr, beta);
  } else {
    reduce_apply_kernel<true><<<blocks, kThreads, smem, s>>>(
        stack, ld, k, w, p, m, d, n, lr, beta);
  }
  return (int)cudaGetLastError();
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
