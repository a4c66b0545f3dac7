// Forward flash attention over [BH, T, hd] q/k/v, sm_90a.
//
// Replaces the TPU kernel `_attn_kernel`, reached through
// `flash_attention` -> `_flash_fwd_impl` in
// colearn_federated_learning_tpu/ops/pallas_attention.py (the
// pallas_call at :141). Same arithmetic:
//
//   q is cast to f32 and scaled by hd^-0.5;  s = q k^T in f32;
//   masked scores are -1e30 (causal keeps k_pos <= q_pos; keys at or past
//   T are masked);  an online softmax keeps m, l and acc in f32 per row,
//   with p re-zeroed where masked;  out = acc / max(l, 1e-30), rounded
//   once to the input dtype (f32 or bf16).
//
// What bounds it on this card. At the path's shape (BERT-tiny: BH = 32,
// T = 80, hd = 64, bf16, causal) one launch reads q, k, v and writes o:
// 4 * 32 * 80 * 64 * 2 B = 1.3 MB, 0.4 us at 3.35 TB/s, and does
// 26.5 MFLOP on the causal pairs, 0.03 us at the bf16 peak; a launch of
// a one-element kernel takes 2 us of device time. Neither bytes nor
// operations bound it: latency does. The path gives 160 blocks of 4
// warps, about one block an SM, so nothing hides the tile loads or the
// dependent shuffles of the online softmax (measured on an H100 80GB
// HBM3 at 700 W by chip_smoke.py: 15 us a launch, 19 us before the rows
// of a warp were interleaved; PERF.md). The design keeps to what is
// simple and correct and never writes a T x T score matrix to device
// memory; more warps per tile, tensor cores (wgmma), TMA and warp
// specialisation are later work.
//
// Design. The TPU grid (b*h, query tile) ran in order on one core; here
// every block owns one (b*h, 16-row query tile) and nothing carries over
// between blocks. Inside the block a loop over 32-key tiles takes the
// place of the TPU's k/v loop: the tile's keys and values are staged in
// shared memory as f32 (k rows padded by one float so that lane j reads
// row j without bank conflicts). Each of the 4 warps owns 4 query rows
// and runs them through every step together, so that each element read
// from shared memory serves four rows and four chains of FMAs overlap.
// For a row, lane j computes the score of key j of the tile, the warp
// reduces the tile's max and sum with shuffles, and each lane keeps the
// output dims lane, lane+32, ... of acc in registers. The causal loop
// stops at the tile that holds the tile's last query, as the TPU kernel
// stops at the diagonal block. The ragged edge is masked here: keys at
// or past T are masked and query rows past T are not written, so nothing
// is padded in device memory.
//
// The launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockKV = 32;                    // keys per tile, one a lane
constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int t,
                       int n_qtiles, int causal, float scale) {
  constexpr int kDimsPerLane = (HD + 31) / 32;
  __shared__ float q_s[kBlockQ][HD];
  __shared__ float k_s[kBlockKV][HD + 1];
  __shared__ float v_s[kBlockKV][HD];

  const long long bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const long long base = bh * t * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the query tile, scaled in f32; rows past t are zero and never written
  for (int i = threadIdx.x; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    q_s[r][d] = q0 + r < t
                    ? to_float(q[base + (long long)(q0 + r) * HD + d]) * scale
                    : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegBig;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] = 0.f;
  }

  // causal: no query of this tile sees a key past its last row
  const int kv_end = causal ? min(t, q0 + kBlockQ) : t;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed, q_s is written
    for (int i = threadIdx.x; i < kBlockKV * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < t;
      const long long g = base + (long long)(k0 + r) * HD + d;
      k_s[r][d] = in ? to_float(k[g]) : 0.f;
      v_s[r][d] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();
    // the warp's rows go through each step together: every k and v
    // element read from shared memory serves all of them, and their
    // chains of FMAs are independent of one another
    const int key = k0 + lane;
    const int r0 = warp * kRowsPerWarp;
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        s[rr] = fmaf(q_s[r0 + rr][d], kd, s[rr]);
      }
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool keep = key < t && (!causal || key <= q0 + r0 + rr);
      const float sv = keep ? s[rr] : kNegBig;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float corr = expf(m[rr] - m_new);
      p[rr] = keep ? expf(sv - m_new) : 0.f;
      l[rr] = l[rr] * corr + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBlockKV; ++j) {
      float vj[kDimsPerLane];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < HD ? v_s[j][d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          acc[rr][i] = fmaf(pj, vj[i], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= t) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        o[base + (long long)row * HD + d] = from_float<T>(acc[rr][i] / denom);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int blocks,
           int t, int n_qtiles, int hd, int causal, float scale,
           cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (hd) {
    case 16:
      flash_attention_kernel<T, 16><<<blocks, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<blocks, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<blocks, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<blocks, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to contiguous [bh, t, hd] arrays of one
// dtype (0 = f32, 1 = bf16); hd is 16, 32, 64 or 128. scale is hd^-0.5
// rounded to f32. stream: a cudaStream_t. Returns a cudaError_t.
int colearn_flash_attention(const void* q, const void* k, const void* v,
                            void* o, long long bh, int t, int hd, int dtype,
                            int causal, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (t + kBlockQ - 1) / kBlockQ;
  const long long blocks = bh * n_qtiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, o, (int)blocks, t, n_qtiles, hd, causal,
                         scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, (int)blocks, t, n_qtiles, hd,
                                 causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
