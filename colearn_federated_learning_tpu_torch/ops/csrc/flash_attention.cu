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
// bf16 (local training and eval on the path): tensor cores for both
// products.
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
// f32 (any model run at f32 compute, as shakespeare_fedavg with
// run.compute_dtype=float32): tensor cores for both products too, at
// f32 accuracy, on the bf16 kernel's skeleton (16-row query tiles, a
// tile's 16-key chunks split over the kSplits warps of its block and
// merged with one division a row, 16-byte cp.async double buffers, the
// online softmax on the accumulator fragments, the causal stop). What
// bounds it on this card. At the path's shape (BERT-tiny,
// [32, 80, 64] causal) it moves 2.62 MB, 0.78 us at 3.35 TB/s, and
// latency bounds it, as the bf16 kernel. At ViT-B/16's eval shape
// ([768, 197, 64], non-causal) it moves 154.9 MB (46.2 us) and does 7.63
// GFLOP: 114 us at the 67 TFLOP/s of the f32 SIMT cores, so a SIMT
// kernel cannot reach half its bound there. Here:
//   - both products run on mma.sync.m16n8k8 tf32 (f32 accumulators)
//     with the 3xTF32 split: each operand x is hi = x rounded to tf32
//     plus lo = (x - hi) rounded the same way (to nearest, ties away,
//     as cvt.rna, but in two integer operations, which ran faster than
//     the conversion instruction), and a product is hi hi + hi lo +
//     lo hi, which drops terms of about 2^-22 |x y| (one tf32 product
//     alone would be off by 2^-11, past the 2e-5 gate);
//   - the tensor cores truncate as they accumulate, so each k-step's
//     hi hi term of q k^T is summed in a zeroed accumulator and added in
//     f32: a running sum there loses bits against the whole score at
//     every step, which shows at peaked softmaxes;
//   - q is scaled in f32, split once and held as A fragments; k's and
//     v's hi and lo parts are made from shared memory as each chunk is
//     used; p is split into tf32 high and low parts, as the bf16 kernel
//     splits it into bf16 ones;
//   - the k-order of each product is chosen so that every operand is
//     one plain shared load (ldmatrix moves 16-bit elements, and its
//     .trans cannot give v's tf32 B operand): k by float2 from rows
//     HD + 8 floats apart, v by scalar loads from rows HD + 4 floats
//     apart, both free of bank conflicts, and p from the C fragment of
//     q k^T to the A fragment of p v in place (see the kernel);
//   - chunks whose keys are all kept skip the mask.
// Measured (tools/flash_f32_compare.py on an H100 80GB HBM3 at 700 W;
// the designs it compared are in PERF.md): the zeroed hi hi accumulator
// brought the largest error against the exact answer, at q and k
// scaled x4, from 0.76 of the gate to 0.35. mma.sync tf32 runs at about
// 180 TFLOP/s here, not the 495 of wgmma, so the three products alone
// take about 140 us at ViT's shape, against 260.6 us for the kernel and
// 46.2 us for its bound: a third of the bound is the most this
// instruction allows, and half would take wgmma. A 64-row block whose
// 4 warps share each k/v chunk (a quarter of the L2 reads) took 255.8
// us against 260.7 there and 8.67 against 7.04 us at the path's shape;
// it was not kept.
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

// ---------------------------------------------------------------------
// f32: mma.sync tf32 tensor cores, 3xTF32

// shared bytes a warp needs: two buffers of one chunk's k rows (HD + 8
// floats apart) and v rows (HD + 4 floats apart)
__host__ __device__ constexpr int kv_f32_bytes_per_warp(int hd) {
  return 2 * kTileQ * ((hd + 8) + (hd + 4)) * 4;
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// as the bits of an f32: what cvt.rna.tf32.f32 gives for finite x, in
// two integer operations instead of a conversion instruction
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 |x|: hi is x rounded to tf32, lo the rest
// rounded the same way
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k8 tf32 (lane = 4 g + tq): A holds rows g and
// g + 8 at k-columns tq and tq + 4, B k-rows tq and tq + 4 at column g,
// and C rows g and g + 8 at columns 2 tq and 2 tq + 1. A product sums
// over k in any order, so each product orders k to suit its loads: in
// q k^T, k-columns tq and tq + 4 of k-step ks are dims 8 ks + 2 tq and
// 8 ks + 2 tq + 1 (one float2 of q and one of k); in p v, those of the
// 8-key step h are keys 8 h + 2 tq and 8 h + 2 tq + 1, the two columns
// of s the thread already holds, so p passes from the C fragment of
// q k^T to the A fragment of p v without a shuffle.
//
// Blocks, chunks, the causal stop and the merge of the kSplits warps are
// the bf16 kernel's.
template <int HD>
__global__ void __launch_bounds__(kSplits * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int t, int n_qtiles, int causal, float scale) {
  constexpr int KS = HD / 8;    // k-steps of q k^T
  constexpr int DN = HD / 8;    // 8-column n-tiles of the output
  constexpr int LDK = HD + 8;   // k row stride (floats): a half-warp's
                                // float2 loads hit 32 distinct banks
  constexpr int LDV = HD + 4;   // v row stride: a warp's loads of rows
                                // 2 tq (+ 1), column g, likewise
  constexpr int VECS = HD / 4;  // 16-byte vectors per row
  constexpr int BUF = kTileQ * (LDK + LDV);  // floats of one buffer
  constexpr int RLD = HD + 8;   // row stride of the merge buffer
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
  float* kv = reinterpret_cast<float*>(
      smem + (size_t)warp * kv_f32_bytes_per_warp(HD));  // [buf][k | v]
  // causal: no row of the tile sees a key past its last row
  const int n_chunks = causal ? qtile + 1 : (t + 15) / 16;

  // q scaled in f32, as A fragments in tf32 high and low parts, straight
  // from device memory: rows past t are zero
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    const float* qr = q + base + (long long)min(row, t - 1) * HD + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 x = row < t
                           ? *reinterpret_cast<const float2*>(qr + 8 * ks)
                           : make_float2(0.f, 0.f);
      split_tf32(__fmul_rn(x.x, scale), qh[ks][h], ql[ks][h]);
      split_tf32(__fmul_rn(x.y, scale), qh[ks][2 + h], ql[ks][2 + h]);
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
    float* kb = kv + buf * BUF;
    float* vb = kb + kTileQ * LDK;
#pragma unroll
    for (int i = lane; i < kTileQ * VECS; i += 32) {
      const int r = i / VECS, d = (i % VECS) * 4;
      const int key = 16 * c + r;
      const long long off = base + (long long)(key < t ? key : 0) * HD + d;
      cp_async16(kb + r * LDK + d, k + off, key < t);
      cp_async16(vb + r * LDV + d, v + off, key < t);
    }
    cp_async_commit();
  };

  // one 16-key chunk c from kb/vb, with keep(h, e) saying which scores
  // of a thread's fragments are kept
  auto chunk = [&](int c, const float* kb, const float* vb, auto keep) {
    // s = q k^T on the chunk as hi hi + (lo hi + hi lo). The hi hi term
    // of each k-step is summed in a zeroed accumulator and added in f32:
    // the tensor cores truncate as they accumulate, so a running sum
    // there would lose bits against the whole score at every step. The
    // small terms run in chains of their own beside it.
    float sb[2][4] = {}, s1[2][4] = {}, s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 kk = *reinterpret_cast<const float2*>(
            kb + (8 * h + g) * LDK + 8 * ks + 2 * tq);
        uint32_t kh0, kl0, kh1, kl1;
        split_tf32(kk.x, kh0, kl0);
        split_tf32(kk.y, kh1, kl1);
        float part[4] = {};
        mma_tf32(part, qh[ks], kh0, kh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[h][e] += part[e];
        mma_tf32(s1[h], ql[ks], kh0, kh1);
        mma_tf32(s2[h], qh[ks], kl0, kl1);
      }
    }
    float s[2][4], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][e] = keep(h, e) ? sb[h][e] + (s1[h][e] + s2[h][e]) : kNegBig;
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
    // acc = acc * corr + p v, p as the A operand in tf32 high and low
    // parts: rows g, g + 8 at key 2 tq, then rows g, g + 8 at 2 tq + 1
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split_tf32(s[h][0], ph[h][0], pl[h][0]);
      split_tf32(s[h][2], ph[h][1], pl[h][1]);
      split_tf32(s[h][1], ph[h][2], pl[h][2]);
      split_tf32(s[h][3], ph[h][3], pl[h][3]);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      float(&a)[4] = acc[dn];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] *= corr[e >> 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* vr = vb + (8 * h + 2 * tq) * LDV + 8 * dn + g;
        uint32_t vh0, vl0, vh1, vl1;
        split_tf32(vr[0], vh0, vl0);
        split_tf32(vr[LDV], vh1, vl1);
        mma_tf32(a, pl[h], vh0, vh1);
        mma_tf32(a, ph[h], vl0, vl1);
        mma_tf32(a, ph[h], vh0, vh1);
      }
    }
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
    const float* kb = kv + buf * BUF;
    const float* vb = kb + kTileQ * LDK;
    // every key of the chunk real, and (causal) at or before every row
    if (16 * c + 16 <= t && (!causal || 16 * c + 15 <= q0)) {
      chunk(c, kb, vb, [](int, int) { return true; });
    } else {
      chunk(c, kb, vb, [&](int h, int e) {
        const int key = 16 * c + 8 * h + 2 * tq + (e & 1);
        const int row = q0 + g + 8 * (e >> 1);
        return key < t && (!causal || key <= row);
      });
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
      *reinterpret_cast<float2*>(&kv[r * RLD + 8 * dn + 2 * tq]) =
          make_float2(acc[dn][2 * i] * alpha, acc[dn][2 * i + 1] * alpha);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileQ * VECS; i += kSplits * 32) {
    const int r = i / VECS, d = 4 * (i % VECS);
    if (q0 + r >= t) continue;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kSplits; ++w) {
      const float4 part = *reinterpret_cast<const float4*>(
          smem + (size_t)w * kv_f32_bytes_per_warp(HD) +
          ((size_t)r * RLD + d) * sizeof(float));
      x.x += part.x;
      x.y += part.y;
      x.z += part.z;
      x.w += part.w;
    }
    *reinterpret_cast<float4*>(o + base + (long long)(q0 + r) * HD + d) = x;
  }
}

// one launch of a (b*h, 16-row query tile) grid of kSplits-warp blocks
// with smem bytes of dynamic shared memory
template <typename T>
int launch_kernel(void (*kernel)(const T*, const T*, const T*, T*, int, int,
                                 int, float),
                  int smem, const void* q, const void* k, const void* v,
                  void* o, long long bh, int t, int causal, float scale,
                  cudaStream_t s) {
  const int n_qtiles = (t + kTileQ - 1) / kTileQ;
  const long long blocks = bh * n_qtiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(int)blocks, kSplits * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, n_qtiles, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v,
              void* o, long long bh, int t, int causal, float scale,
              cudaStream_t s) {
  if (dtype == 0) {
    return launch_kernel<float>(flash_attention_f32_kernel<HD>,
                                kSplits * kv_f32_bytes_per_warp(HD), q, k, v,
                                o, bh, t, causal, scale, s);
  }
  return launch_kernel<__nv_bfloat16>(flash_attention_bf16_kernel<HD>,
                                      kSplits * kv_bytes_per_warp(HD), q, k,
                                      v, o, bh, t, causal, scale, s);
}

int launch(const void* q, const void* k, const void* v, void* o,
           long long bh, int t, int hd, int dtype, int causal, float scale,
           cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_hd<16>(dtype, q, k, v, o, bh, t, causal, scale, s);
    case 32:
      return launch_hd<32>(dtype, q, k, v, o, bh, t, causal, scale, s);
    case 64:
      return launch_hd<64>(dtype, q, k, v, o, bh, t, causal, scale, s);
    case 128:
      return launch_hd<128>(dtype, q, k, v, o, bh, t, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: device pointers to contiguous [bh, t, hd] arrays of one
// dtype (0 = f32, 1 = bf16), 16-byte aligned; hd is 16, 32, 64 or 128.
// scale is hd^-0.5 rounded to f32. stream: a cudaStream_t. Returns a
// cudaError_t.
int colearn_flash_attention(const void* q, const void* k, const void* v,
                            void* o, long long bh, int t, int hd, int dtype,
                            int causal, float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (bh <= 0 || t <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(q, k, v, o, bh, t, hd, dtype, causal, scale,
                static_cast<cudaStream_t>(stream));
}

const char* colearn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
