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
// Two kernels, one per input dtype.
//
// bf16 (local training on the path): tensor cores for both products.
// What bounds it on this card. At the path's shape (BERT-tiny: BH = 32,
// T = 80, hd = 64, causal) one launch reads q, k, v and writes o:
// 4 * 32 * 80 * 64 * 2 B = 1.3 MB, 0.4 us at 3.35 TB/s, and does
// 26.5 MFLOP on the causal pairs, 0.03 us at the bf16 peak; a launch of
// a one-element kernel takes 2 us of device time. Neither bytes nor
// operations bound it: the latency of the longest dependent chain does
// (load q and k/v, then per 16-key chunk: q k^T, mask, softmax, p v;
// then the division and the store). The SIMT kernel this replaces
// (15 us a launch, measured on an H100 80GB HBM3 at 700 W by
// chip_smoke.py; PERF.md) ran that chain on 4-warp blocks, about one an
// SM, with k/v staged as f32 by scalar loads behind two barriers a tile,
// scores as FMAs from shared memory, 5-step 32-lane shuffle trees for
// each row's max and sum, and a shuffle per key and row to broadcast p;
// the tensor cores were idle. Here:
//   - both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulators
//     in registers): a 16-key chunk of a 16-row tile is 2 * hd/16 mma's
//     for q k^T and hd/8 for each bf16 part of p v. wgmma is not used:
//     its 64-row tile would leave 48 of 128 rows empty at T = 80, and
//     the whole problem is 32 x 80 query rows;
//   - k and v stay bf16 and move by 16-byte cp.async into shared memory
//     (rows padded by 16 bytes, so ldmatrix reads 8 rows without bank
//     conflicts); the next chunk's copy runs under this chunk's
//     products; ldmatrix feeds k, ldmatrix.trans v;
//   - the online softmax runs on the accumulator fragments: a thread
//     holds 2 rows' scores, so a row's max and sum take the 2 shuffles
//     inside its quad;
//   - p stays in registers as the A operand of p v (FlashAttention-2);
//   - a query tile's chunks are shared out over the kSplits = 4 warps of
//     its block, each with its own online softmax, merged at the end
//     through shared memory with one division a row. With one warp a
//     tile, the tile next to the diagonal runs its 5 chunks and 32
//     divisions a thread in one dependent chain on one of the SM's 4
//     schedulers; split over 4 warps the chain is 2 chunks, and the warps
//     run on all 4 schedulers at once (one warp a tile took 9.16 us
//     against 6.12 us a launch, chip_smoke.py on an H100 80GB HBM3 at
//     700 W; PERF.md);
//   - under the causal mask a tile stops at the chunk that holds its
//     last row's key.
// The grid is (b*h, 16-row query tile), 160 blocks at the path's shape.
// Rounding kept to the reference's (the bf16 gate is one bf16 ulp +
// 2e-5 of the plain version). q k^T takes the raw bf16 q and k (each
// product exact in f32) and scales the f32 score by hd^-0.5: for hd 16
// and 64 the scale is a power of two and this is the reference's value;
// for hd 32 and 128 it differs by f32 rounding only. The reference
// multiplies an f32 p by v; rounding p to bf16 once would cost up to
// 2^-9 relative per term, more than the gate allows where the output is
// small, so p is split into a bf16 high part and a bf16 low part
// (p - hi) and p v is two mma's (error about 2^-17 relative). Row sums
// use the f32 p. The merge scales each warp's acc by
// e^(m_w - M) / max(L, 1e-30), one division a row, where the reference
// divides acc by max(l, 1e-30): the two differ by f32 rounding only.
//
// f32 (eval on the server's f32 params): the SIMT kernel of the first
// port, unchanged. Every block owns one (b*h, 16-row query tile); a loop
// over 32-key tiles staged in shared memory as f32 (k rows padded by one
// float so lane j reads row j without bank conflicts) takes the place of
// the TPU's k/v loop. Each of the 4 warps owns 4 query rows and runs them
// through every step together; for a row, lane j computes the score of
// key j of the tile, the warp reduces the tile's max and sum with
// shuffles, and each lane keeps output dims lane, lane+32, ... of acc.
//
// Both kernels mask the ragged edge themselves: keys at or past T are
// masked and query rows past T are not written, so nothing is padded in
// device memory. The causal loop stops at the tile that holds the last
// query, as the TPU kernel stops at the diagonal block. The launch runs
// on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kNegBig = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// f32: SIMT

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockKV = 32;                    // keys per tile, one a lane

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int t, int n_qtiles, int causal, float scale) {
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
    q_s[r][d] = q0 + r < t ? q[base + (long long)(q0 + r) * HD + d] * scale
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
      k_s[r][d] = in ? k[g] : 0.f;
      v_s[r][d] = in ? v[g] : 0.f;
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
      if (d < HD) o[base + (long long)row * HD + d] = acc[rr][i] / denom;
    }
  }
}

// ---------------------------------------------------------------------
// bf16: mma.sync tensor cores

constexpr int kSplits = 4;  // warps a query tile's keys are split over
constexpr int kTileQ = 16;  // query rows per tile (the mma's M), and keys
                            // per chunk (its K)

// shared bytes a warp needs: two buffers of one chunk's k and v rows
__host__ __device__ constexpr int kv_bytes_per_warp(int hd) {
  return 2 * 2 * kTileQ * (hd + 8) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// f32 pair (x, y) -> bf16 high parts and bf16 low parts (x - hi(x))
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x);
  const __nv_bfloat16 yh = __float2bfloat16_rn(y);
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(xh)),
                 __float2bfloat16_rn(y - __bfloat162float(yh)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Fragment layout of m16n8k16 (lane = 4 g + tq): a thread holds rows g
// and g + 8 of a 16-row tile; in an accumulator c[e] of an 8-column
// n-tile it holds row g + 8 (e >> 1), column 2 tq + (e & 1).
//
// One block owns one (b*h, 16-row query tile). Its kSplits warps share
// out the tile's 16-key chunks (warp w takes chunks w, w + kSplits, ...),
// each with its own online softmax over its chunks, then merge: with
// M = max_w m_w and L = sum_w l_w e^(m_w - M), out = sum_w acc_w
// e^(m_w - M) / max(L, 1e-30).
template <int HD>
__global__ void __launch_bounds__(kSplits * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ o, int t,
                            int n_qtiles, int causal, float scale) {
  constexpr int KS = HD / 16;   // k-steps of q k^T
  constexpr int DN = HD / 8;    // 8-column n-tiles of the output
  constexpr int LD = HD + 8;    // shared row stride: 16 bytes of padding
  constexpr int VECS = HD / 8;  // 16-byte vectors per row
  constexpr int RLD = HD + 4;   // row stride of the merge buffer (floats)
  // per warp: two buffers of one chunk's k and v rows, and (after the
  // loop, in the same bytes) the warp's scaled acc for the merge
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float m_s[kSplits][kTileQ], l_s[kSplits][kTileQ];

  const long long bh = blockIdx.x / n_qtiles;
  const int qtile = blockIdx.x % n_qtiles;
  const int q0 = qtile * kTileQ;
  const long long base = bh * t * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  auto* kv = reinterpret_cast<__nv_bfloat16(*)[2][kTileQ][LD]>(
      smem + (size_t)warp * kv_bytes_per_warp(HD));  // [buf][k|v][row][d]
  auto* red = reinterpret_cast<float(*)[RLD]>(
      smem + (size_t)warp * kv_bytes_per_warp(HD));  // [row][d]
  // causal: no row of the tile sees a key past its last row
  const int n_chunks = causal ? qtile + 1 : (t + 15) / 16;

  // q as A fragments, straight from device memory: rows past t are zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + base + (long long)min(row, t - 1) * HD + 2 * tq);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][h] = row < t ? qr[8 * ks] : 0u;
      qa[ks][2 + h] = row < t ? qr[8 * ks + 4] : 0u;
    }
  }

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};

  // chunk c's 16 k and v rows into buffer buf; rows at or past t are zero
  auto load_chunk = [&](int buf, int c) {
#pragma unroll
    for (int i = lane; i < kTileQ * VECS; i += 32) {
      const int r = i / VECS, d = (i % VECS) * 8;
      const int key = 16 * c + r;
      const long long off = base + (long long)(key < t ? key : 0) * HD + d;
      cp_async16(&kv[buf][0][r][d], k + off, key < t);
      cp_async16(&kv[buf][1][r][d], v + off, key < t);
    }
    cp_async_commit();
  };

  if (warp < n_chunks) load_chunk(0, warp);
  for (int c = warp, j = 0; c < n_chunks; c += kSplits, ++j) {
    const int buf = j & 1;
    if (c + kSplits < n_chunks) {
      load_chunk(buf ^ 1, c + kSplits);  // under this chunk's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    auto keep = [&](int h, int e) {
      const int key = 16 * c + 8 * h + 2 * tq + (e & 1);
      const int row = q0 + g + 8 * (e >> 1);
      return key < t && (!causal || key <= row);
    };
    // s = q k^T on the chunk, scaled and masked
    float s[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];  // keys 0.. and 8.. of the chunk, dims 16ks.. and +8
      ldmatrix_x4(kb, &kv[buf][0][(lane & 7) + 8 * (lane >> 4)]
                         [16 * ks + 8 * ((lane >> 3) & 1)]);
      mma_bf16(s[0], qa[ks], kb[0], kb[1]);
      mma_bf16(s[1], qa[ks], kb[2], kb[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][e] = keep(h, e) ? s[h][e] * scale : kNegBig;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[h][e]);
      }
    }
    // the online softmax on the fragments: rows g and g + 8
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][e] = keep(h, e) ? expf(s[h][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[h][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
    // acc = acc * corr + p v, p as the A operand in two bf16 parts
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DN / 2; ++dp) {
      uint32_t vb[4];  // keys 0.. and 8.. of the chunk, dims 16dp.. and +8
      ldmatrix_x4_trans(vb, &kv[buf][1][(lane & 7) + 8 * ((lane >> 3) & 1)]
                               [8 * (2 * dp + (lane >> 4))]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float(&a)[4] = acc[2 * dp + h];
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] *= corr[e >> 1];
        mma_bf16(a, ph, vb[2 * h], vb[2 * h + 1]);
        mma_bf16(a, pl, vb[2 * h], vb[2 * h + 1]);
      }
    }
    __syncwarp();  // buffer buf is free for this warp's chunk after next
  }

  // merge the warps' partial softmaxes
  if (tq == 0) {
    m_s[warp][g] = m[0];
    m_s[warp][g + 8] = m[1];
    l_s[warp][g] = l[0];
    l_s[warp][g + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    float mm = kNegBig, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kSplits; ++w) mm = fmaxf(mm, m_s[w][r]);
#pragma unroll
    for (int w = 0; w < kSplits; ++w) ll += l_s[w][r] * expf(m_s[w][r] - mm);
    const float alpha = expf(m[i] - mm) / fmaxf(ll, 1e-30f);
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      *reinterpret_cast<float2*>(&red[r][8 * dn + 2 * tq]) =
          make_float2(acc[dn][2 * i] * alpha, acc[dn][2 * i + 1] * alpha);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileQ * HD / 2; i += kSplits * 32) {
    const int r = i / (HD / 2), d = 2 * (i % (HD / 2));
    if (q0 + r >= t) continue;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < kSplits; ++w) {
      const float2 part = *reinterpret_cast<const float2*>(
          smem + (size_t)w * kv_bytes_per_warp(HD) +
          ((size_t)r * RLD + d) * sizeof(float));
      x += part.x;
      y += part.y;
    }
    *reinterpret_cast<uint32_t*>(o + base + (long long)(q0 + r) * HD + d) =
        pack_bf16(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               long long bh, int t, int hd, int causal, float scale,
               cudaStream_t s) {
  const int n_qtiles = (t + kBlockQ - 1) / kBlockQ;
  const long long blocks = bh * n_qtiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  const int nb = (int)blocks;
  switch (hd) {
    case 16:
      flash_attention_f32_kernel<16><<<nb, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 32:
      flash_attention_f32_kernel<32><<<nb, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 64:
      flash_attention_f32_kernel<64><<<nb, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    case 128:
      flash_attention_f32_kernel<128><<<nb, kThreads, 0, s>>>(
          qp, kp, vp, op, t, n_qtiles, causal, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* o,
                   int blocks, int t, int n_qtiles, int causal, float scale,
                   cudaStream_t s) {
  constexpr int smem = kSplits * kv_bytes_per_warp(HD);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_attention_bf16_kernel<HD><<<blocks, kSplits * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      t, n_qtiles, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long bh, int t, int hd, int causal, float scale,
                cudaStream_t s) {
  const int n_qtiles = (t + kTileQ - 1) / kTileQ;
  const long long blocks = bh * n_qtiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int nb = (int)blocks;
  switch (hd) {
    case 16:
      return launch_bf16_hd<16>(q, k, v, o, nb, t, n_qtiles, causal, scale,
                                s);
    case 32:
      return launch_bf16_hd<32>(q, k, v, o, nb, t, n_qtiles, causal, scale,
                                s);
    case 64:
      return launch_bf16_hd<64>(q, k, v, o, nb, t, n_qtiles, causal, scale,
                                s);
    case 128:
      return launch_bf16_hd<128>(q, k, v, o, nb, t, n_qtiles, causal, scale,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to contiguous [bh, t, hd] arrays of one
// dtype (0 = f32, 1 = bf16; bf16 pointers 16-byte aligned); hd is 16,
// 32, 64 or 128. scale is hd^-0.5 rounded to f32. stream: a
// cudaStream_t. Returns a cudaError_t.
int colearn_flash_attention(const void* q, const void* k, const void* v,
                            void* o, long long bh, int t, int hd, int dtype,
                            int causal, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(q, k, v, o, bh, t, hd, causal, scale, s);
  if (dtype == 1) {
    return launch_bf16(q, k, v, o, bh, t, hd, causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
