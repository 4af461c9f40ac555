// Hopper (sm_90a) forward kernels for causal (or full) GQA softmax attention
// with an optional sliding window, online softmax over key tiles.  Plain C
// entry point, bound with ctypes by ../kernel.py; it returns
// cudaGetLastError().
//
// Replaces (reference package, Pallas on TPU):
//   flash_attention <- repro/kernels/flash_attention/kernel.py::flash_attention
//
// The function: q (B, S, H, D), k and v (B, T, KV, D), H = KV * G, query
// head h = kv * G + g reads key head kv.  Query s sees key t when t <= s
// (causal) and t > s - window (window > 0).  Scores, the online softmax
// (m, l) and the p @ v sums are f32; the output is in q's type.  A masked
// score is -1e30, as in the TPU kernel, a key tile that every row of a
// block masks is skipped, and l is clamped to 1e-30 before the division.
// Rows are the TPU kernel's: row = s * G + g of one (batch, kv head), so
// the G query heads that share a key head share the block's key tiles.
// The TPU kernel carries (m, l, acc) across the kv axis of its grid in
// VMEM; here blocks run in parallel, so one block takes one (batch * kv
// head, tile of query rows) and loops over the key tiles itself, visiting
// only those some row of it can see, and masks the ragged edges (window
// start, causal end, T) itself, with no padding copies.
//
// What bounds it on an H100: about 4 * D operations per (query row, live
// key) pair against a few hundred MB of q, k, v and out, so operations
// bound it.  At recurrentgemma-2b's prefill shape (B 8, S 4096, H 10, KV 1,
// D 256, window 2048) that is 5.15e11 operations: 0.52 ms at the bf16
// tensor-core peak (989 TFLOP/s), 7.7 ms at the f32 rate outside the
// tensor cores (67 TFLOP/s).  So the two input types take two kernels.
//
// bf16 (flash_fwd_bf16_kernel): both products on the tensor cores, with
// mma.sync.m16n8k16 (bf16 x bf16, f32 accumulate).  A bf16 product is exact
// in f32, so the scores differ from the plain version's only in the order
// of the sums; p is rounded to bf16 for p @ v, as in FlashAttention-2, the
// one rounding the f32 kernel does not make (l sums the unrounded p).
//   - 128 query rows a block, 16 a warp over 8 warps, or where D <= 64
//     32 a warp over 4 warps (two 16-row fragments: the products are
//     short there, and each K or V fragment read from shared memory then
//     feeds two of them; faster on an H100 at smollm-135m's prefill);
//     keys in tiles of 64.
//   - Shared memory holds only the q tile and a two-stage ring of K and V
//     tiles (at D = 256: 66 KB + 2 x 2 x 33 KB), rows padded by 16 bytes so
//     that the eight rows of every ldmatrix fall on distinct banks.  16-byte
//     cp.async copies fill tile i+1 while tile i is multiplied, with one
//     barrier a tile: tile i+1's copies start just after the barrier that
//     sees tile i landed and tile i-1 (the stage they overwrite) consumed.
//   - Operands come from shared memory by ldmatrix (.trans for V, stored
//     keys x D); each warp's scores stay in registers as mma fragments, so
//     the row max and row sum take two quad shuffles, and m, l and the
//     accumulator (16 x 256 f32 a warp, 128 registers a thread, at
//     D = 256) never leave registers.  p is repacked from the score fragment straight into the
//     A operand of p @ v.  The softmax runs in base 2: scores are scaled
//     by log2(e) / sqrt(D) and exponentials are exp2f (no fast math), so
//     p = 2^(s log2(e) - m) is e^(s - m) up to the rounding of the folded
//     scale, one multiply per score fewer than expf.
//   - Blocks are issued heaviest row tile first (the causal end), so the
//     last wave holds the shortest tiles.
//   - Still open: wgmma fed by TMA (mma.sync issues from each warp and
//     reads K and V from shared memory once a warp, 8 times a tile).
//
// f32 (flash_fwd_kernel): full f32 products on the CUDA cores (the 2e-5
// tolerance needs them), so the f32 rate is its ceiling.  The block's q
// rows and each key tile's K and V rows sit in shared memory (rows padded
// by 4 floats, so the float4 reads below fall on distinct banks).  A key
// tile is two register-tiled products, as in a CUDA-core matrix multiply:
//   scores: each thread owns 4 rows x 4 keys of the 64 x 64 score tile, so
//     every float4 of q or K it reads from shared memory feeds 4 rows or 4
//     keys (16 FMAs per two 128-bit loads);
//   softmax: 4 threads a row take the row's maximum and sum with two xor
//     shuffles, keep m and l in registers, and leave p and the rescale
//     factor in shared memory;
//   p @ v: each thread owns RPT rows x (C float4 columns) of the output
//     accumulator in registers (4 x 16 floats at D = 256), so every float4
//     of V it reads feeds RPT rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                // query rows per block
constexpr int kKeys = 64;                // keys per tile
constexpr int kPad = 4;                  // floats of padding per smem row
constexpr int kLP = kKeys + kPad;        // row stride of the p tile
constexpr float kNegInf = -1e30f;

// four consecutive elements, 4-element aligned, as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

__device__ __forceinline__ float4& at4(float* base, int i) {
  return *reinterpret_cast<float4*>(base + i);
}

__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kRows + 2 * kKeys) * (D + kPad) + kRows * kLP + kRows);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int LD = D + kPad;           // row stride of q, K and V tiles
  constexpr int D4 = D / 4;
  // p @ v layout: TX threads across the float4 columns, TY across rows
  constexpr int TX = D4 < 16 ? D4 : 16;
  constexpr int TY = kThreads / TX;
  constexpr int RPT = kRows / TY;        // rows a thread accumulates
  constexpr int C = D4 / TX;             // float4 columns a thread holds
  static_assert(kRows == 16 * 4 && kKeys == 16 * 4 && kRows * 4 == kThreads,
                "the score and softmax layouts assume 64 x 64 tiles");
  static_assert(TY * RPT == kRows && TX * C == D4 &&
                    (kKeys * D4) % kThreads == 0,
                "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kRows x LD
  float* ks = qs + kRows * LD;                   // kKeys x LD
  float* vs = ks + kKeys * LD;                   // kKeys x LD
  float* ps = vs + kKeys * LD;                   // kRows x kLP
  float* corr_s = ps + kRows * kLP;              // kRows

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int64_t n_rows = (int64_t)S * G;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int tid = threadIdx.x;

  // the key tiles some row of this block can see
  const int s_lo = (int)(r0 / G);
  const int s_hi =
      (int)(((r0 + kRows < n_rows ? r0 + kRows : n_rows) - 1) / G);
  int k_begin = 0, k_end = T_;
  if (causal) k_end = min(T_, s_hi + 1);
  if (window > 0) k_begin = max(0, s_lo - window + 1);
  k_begin = (k_begin / kKeys) * kKeys;

  // the block's q rows; rows past the end are zeros and write nothing
  for (int u = tid; u < kRows * D4; u += kThreads) {
    const int r = u / D4, c = u % D4;
    const int64_t rr = r0 + r;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < n_rows) {
      const int sq = (int)(rr / G), h = kvh * G + (int)(rr % G);
      f = load4(q + (((int64_t)b * S + sq) * H + h) * D + c * 4);
    }
    at4(qs, r * LD + c * 4) = f;
  }

  // scores layout: 16 x 16 threads, rows ty * 4 + i, keys tx + 16 * j
  const int ty = tid / 16, tx = tid % 16;
  int sq_s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t rr = r0 + ty * 4 + i;
    sq_s[i] = (int)((rr < n_rows ? rr : n_rows - 1) / G);
  }
  // softmax layout: 4 threads a row, keys part + 4 * c
  const int srow = tid / 4, part = tid % 4;
  float m_run = kNegInf, l_run = 0.f;
  // p @ v layout
  const int py = tid / TX, px = tid % TX;
  float4 acc[RPT][C];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int64_t key_stride = (int64_t)KV * D;
  const T* kb = k + ((int64_t)b * T_ * KV + kvh) * D;
  const T* vb = v + ((int64_t)b * T_ * KV + kvh) * D;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();                     // the previous tile is consumed
#pragma unroll
    for (int it = 0; it < kKeys * D4 / kThreads; ++it) {
      const int u = tid + it * kThreads;
      const int r = u / D4, c = u % D4;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (k0 + r < T_) {
        kf = load4(kb + (int64_t)(k0 + r) * key_stride + c * 4);
        vf = load4(vb + (int64_t)(k0 + r) * key_stride + c * 4);
      }
      at4(ks, r * LD + c * 4) = kf;
      at4(vs, r * LD + c * 4) = vf;
    }
    __syncthreads();

    // scores = q K^T over the tile, 4 x 4 a thread
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[i] = at4(qs, (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kf[j] = at4(ks, (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sacc[i][j] = fmaf(qf[i].x, kf[j].x, sacc[i][j]);
          sacc[i][j] = fmaf(qf[i].y, kf[j].y, sacc[i][j]);
          sacc[i][j] = fmaf(qf[i].z, kf[j].z, sacc[i][j]);
          sacc[i][j] = fmaf(qf[i].w, kf[j].w, sacc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool live = kj < T_;
        if (causal) live = live && kj <= sq_s[i];
        if (window > 0) live = live && kj > sq_s[i] - window;
        ps[(ty * 4 + i) * kLP + tx + 16 * j] =
            live ? sacc[i][j] * scale : kNegInf;
      }
    __syncthreads();

    // online softmax over the tile's scores of one row
    {
      float sv[kKeys / 4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys / 4; ++c) {
        sv[c] = ps[srow * kLP + part + 4 * c];
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = expf(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys / 4; ++c) {
        const float p = expf(sv[c] - m_new);
        ps[srow * kLP + part + 4 * c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (part == 0) corr_s[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ V over the tile
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float cr = corr_s[py * RPT + i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[i][c].x *= cr;
        acc[i][c].y *= cr;
        acc[i][c].z *= cr;
        acc[i][c].w *= cr;
      }
    }
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 pf[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pf[i] = at4(ps, (py * RPT + i) * kLP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 vv = at4(vs, (j + jj) * LD + (px + TX * c) * 4);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = comp(pf[i], jj);
            acc[i][c].x = fmaf(p, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(p, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(p, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(p, vv.w, acc[i][c].w);
          }
        }
      }
    }
  }

  // normalise by each row's l and write the rows that exist
  __syncthreads();
  if (part == 0) corr_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t rr = r0 + py * RPT + i;
    if (rr >= n_rows) continue;
    const float inv = 1.0f / fmaxf(corr_s[py * RPT + i], 1e-30f);
    const int sq = (int)(rr / G), h = kvh * G + (int)(rr % G);
    T* orow = out + (((int64_t)b * S + sq) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = (px + TX * c) * 4;
      orow[d] = from_f32<T>(acc[i][c].x * inv);
      orow[d + 1] = from_f32<T>(acc[i][c].y * inv);
      orow[d + 2] = from_f32<T>(acc[i][c].z * inv);
      orow[d + 3] = from_f32<T>(acc[i][c].w * inv);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 128;               // query rows per block
constexpr int kKeys = 64;                // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kPad = 8;                  // bf16 of padding per smem row

// 16-row fragments a warp: two where D <= 64, whose products are short,
// so that each K or V fragment read from shared memory feeds two products
template <int D>
__host__ __device__ constexpr int frags() { return D <= 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int threads() {
  return 32 * kRows / (16 * frags<D>());
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kRows + 2 * kStages * kKeys) *
         (D + kPad);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and each lane gets (row lane / 4, cols 2 (lane % 4) + {0, 1})
// of each (with .trans: (rows 2 (lane % 4) + {0, 1}, col lane / 4))
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig): the f32
// accumulator c[0..1] is (row gid, cols 2 tig + {0, 1}) and c[2..3] the
// same cols of row gid + 8; the A operand a[0..3] is (row gid, k 2 tig),
// (row gid + 8, k 2 tig), (row gid, k 2 tig + 8), (row gid + 8, k 2 tig
// + 8), pairs of bf16; B's b0, b1 are (k 2 tig + {0, 1}, col gid) and
// k + 8.  So two score fragments side by side (keys 0-7 and 8-15) are, in
// bf16, exactly the A operand of p @ v over those 16 keys.
template <int D>
__global__ void __launch_bounds__(threads<D>(), D <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int S, int T_, int H,
                      int KV, int causal, int window, float scale,
                      int n_tiles, int n_bh) {
  constexpr int MF = frags<D>();         // 16-row fragments a warp
  constexpr int NTH = threads<D>();
  constexpr int LD = D + kPad;           // smem row stride, bf16
  constexpr int CPR = D / 8;             // 16-byte chunks per row
  constexpr int NT = kKeys / 8;          // score fragments per 16 rows
  constexpr int DT = D / 8;              // accumulator fragments per 16 rows
  static_assert(D % 32 == 0 && (kKeys * CPR) % NTH == 0 &&
                    (kRows * CPR) % NTH == 0,
                "head_dim must be a multiple of 32");
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* ks = qs + kRows * LD;              // kStages x kKeys x LD
  __nv_bfloat16* vs = ks + kStages * kKeys * LD;    // kStages x kKeys x LD

  // the heaviest row tiles (the causal end) of every (batch, kv head) first
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (unsigned int)n_bh);
  const int bh = (int)(blockIdx.x % (unsigned int)n_bh);
  const int G = H / KV;
  const int b = bh / KV, kvh = bh % KV;
  const int64_t n_rows = (int64_t)S * G;
  const int64_t r0 = (int64_t)tile * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the key tiles some row of this block can see
  const int s_lo = (int)(r0 / G);
  const int s_hi =
      (int)(((r0 + kRows < n_rows ? r0 + kRows : n_rows) - 1) / G);
  int k_begin = 0, k_end = T_;
  if (causal) k_end = min(T_, s_hi + 1);
  if (window > 0) k_begin = max(0, s_lo - window + 1);
  k_begin = (k_begin / kKeys) * kKeys;
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                   : 0;

  const int64_t key_stride = (int64_t)KV * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * T_ * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * T_ * KV + kvh) * D;

  // the block's q rows; rows past the end are zero-filled and write nothing
#pragma unroll
  for (int it = 0; it < kRows * CPR / NTH; ++it) {
    const int u = tid + it * NTH;
    const int r = u / CPR, c = u % CPR;
    const int64_t rr = r0 + r;
    const bool ok = rr < n_rows;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int sq = (int)(rr / G), h = kvh * G + (int)(rr % G);
      src = q + (((int64_t)b * S + sq) * H + h) * D + c * 8;
    }
    cp_async16(smem_u32(qs + r * LD + c * 8), src, ok);
  }
  // K and V rows k0..k0+63 into ring stage st; keys past T are zeros
  auto load_kv = [&](int k0, int st) {
    __nv_bfloat16* kd = ks + st * kKeys * LD;
    __nv_bfloat16* vd = vs + st * kKeys * LD;
#pragma unroll
    for (int it = 0; it < kKeys * CPR / NTH; ++it) {
      const int u = tid + it * NTH;
      const int r = u / CPR, c = u % CPR;
      const bool ok = k0 + r < T_;
      const int64_t off = ok ? (int64_t)(k0 + r) * key_stride + c * 8 : 0;
      cp_async16(smem_u32(kd + r * LD + c * 8), kb + off, ok);
      cp_async16(smem_u32(vd + r * LD + c * 8), vb + off, ok);
    }
  };
  if (n_kt > 0) load_kv(k_begin, 0);
  cp_async_commit();                     // group: q and the first tile

  // this thread's rows: gid and gid + 8 of each of the warp's fragments
  const int64_t row0 = r0 + warp * 16 * MF + gid;
  int sq[MF][2];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int64_t rr = row0 + 16 * f + 8 * hf;
      sq[f][hf] = (int)((rr < n_rows ? rr : n_rows - 1) / G);
    }
  // m is a row's running max of the base-2 scores; -1e30 stays the mask
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[MF][2], l[MF][2], acc[MF][DT][4];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    m[f][0] = m[f][1] = kNegInf;
    l[f][0] = l[f][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
  }

  // ldmatrix row addresses (bytes): q rows of the warp as the A operand;
  // K as B of two key fragments (keys 0-7 then 8-15, k 0-7 then 8-15);
  // V transposed as B of two column fragments (keys 0-7 then 8-15 of
  // cols 0-7, then of cols 8-15)
  const uint32_t q_addr =
      smem_u32(qs) +
      2u * ((warp * 16 * MF + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_lane =
      2u * (((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane =
      2u * (((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8);

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = k_begin + it * kKeys;
    const int st = it & 1;
    cp_async_wait_all();                 // this tile (and q) have landed
    // one barrier a tile: every warp has landed its copies, and has left
    // tile it-1, whose stage the next copies overwrite
    __syncthreads();
    if (it + 1 < n_kt) load_kv(k0 + kKeys, st ^ 1);
    cp_async_commit();
    const uint32_t k_addr = smem_u32(ks + st * kKeys * LD) + k_lane;
    const uint32_t v_addr = smem_u32(vs + st * kKeys * LD) + v_lane;

    // scores = q K^T: 16 MF rows x 64 keys a warp, in registers
    float sc[MF][NT][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[f][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f)
        ldsm_x4(a[f], q_addr + 2u * (f * 16 * LD) + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, k_addr + 2u * (np * 16 * LD + kk * 16));
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          mma_bf16(sc[f][2 * np], a[f], bk[0], bk[1]);
          mma_bf16(sc[f][2 * np + 1], a[f], bk[2], bk[3]);
        }
      }
    }

    // scale (by log2(e) / sqrt(D): the softmax runs in base 2), and mask
    // unless every row of the block sees the whole tile
    const bool full = k0 + kKeys <= T_ &&
                      (!causal || k0 + kKeys - 1 <= s_lo) &&
                      (window <= 0 || k0 > s_hi - window);
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[f][j][e] * scale_log2;
          if (!full) {
            const int kj = k0 + j * 8 + 2 * tig + (e & 1);
            const int sr = sq[f][e >> 1];
            bool live = kj < T_;
            if (causal) live = live && kj <= sr;
            if (window > 0) live = live && kj > sr - window;
            x = live ? x : kNegInf;
          }
          sc[f][j][e] = x;
        }

    // online softmax: a row's 64 scores lie on the 4 lanes of a quad;
    // p goes to bf16 pairs, p[f][j][hf] for row gid + 8 hf
    uint32_t p[MF][NT][2];
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          mx[hf] = fmaxf(mx[hf], fmaxf(sc[f][j][2 * hf], sc[f][j][2 * hf + 1]));
      float mn[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        mn[hf] = fmaxf(m[f][hf], mx[hf]);
        corr[hf] = exp2f(m[f][hf] - mn[hf]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float p0 = exp2f(sc[f][j][2 * hf] - mn[hf]);
          const float p1 = exp2f(sc[f][j][2 * hf + 1] - mn[hf]);
          sum[hf] += p0 + p1;
          p[f][j][hf] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
        sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
        l[f][hf] = l[f][hf] * corr[hf] + sum[hf];
        m[f][hf] = mn[hf];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[f][j][0] *= corr[0];
        acc[f][j][1] *= corr[0];
        acc[f][j][2] *= corr[1];
        acc[f][j][3] *= corr[1];
      }
    }

    // acc += p V over the tile, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        a[f][0] = p[f][2 * kk][0];
        a[f][1] = p[f][2 * kk][1];
        a[f][2] = p[f][2 * kk + 1][0];
        a[f][3] = p[f][2 * kk + 1][1];
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_addr + 2u * (kk * 16 * LD + dp * 16));
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          mma_bf16(acc[f][2 * dp], a[f], bv[0], bv[1]);
          mma_bf16(acc[f][2 * dp + 1], a[f], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait_all();

  // normalise by each row's l and write the rows that exist
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int64_t rr = row0 + 16 * f + 8 * hf;
      if (rr >= n_rows) continue;
      const float inv = 1.0f / fmaxf(l[f][hf], 1e-30f);
      const int sr = (int)(rr / G), h = kvh * G + (int)(rr % G);
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          out + (((int64_t)b * S + sr) * H + h) * D + 2 * tig);
#pragma unroll
      for (int j = 0; j < DT; ++j)
        orow[j * 4] = pack_bf16(acc[f][j][2 * hf] * inv,
                                acc[f][j][2 * hf + 1] * inv);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KV, int causal, int window, float scale,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_tiles = ((int64_t)S * (H / KV) + kRows - 1) / kRows;
  const int64_t blocks = n_tiles * B * KV;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd_bf16_kernel<D><<<(unsigned int)blocks, threads<D>(), smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, T_, H, KV, causal,
      window, scale, (int)n_tiles, B * KV);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KV, int causal, int window, float scale,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_rows = (int64_t)S * (H / KV);
  const dim3 grid((unsigned int)((n_rows + kRows - 1) / kRows),
                  (unsigned int)(B * KV), 1);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, T_, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

// dtype 0 (f32) on the CUDA-core kernel, dtype 1 (bf16) on the tensor cores
template <int D>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             void* out, int B, int S, int T_, int H, int KV, int causal,
             int window, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, B, S, T_, H, KV, causal, window,
                            scale, s);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, out, B, S, T_, H, KV, causal, window,
                         scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  head_dim D in {32, 64, 128, 256};
// window <= 0 means none.  q, out (B, S, H, D); k, v (B, T, KV, D), each
// 16-byte aligned.
int flash_attention(int dtype, const void* q, const void* k, const void* v,
                    void* out, int B, int S, int T, int H, int KV, int D,
                    int causal, int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || S <= 0 || T <= 0) return (int)cudaGetLastError();
  switch (D) {
    case 32: return dispatch<32>(dtype, q, k, v, out, B, S, T, H, KV, causal, window, scale, s);
    case 64: return dispatch<64>(dtype, q, k, v, out, B, S, T, H, KV, causal, window, scale, s);
    case 128: return dispatch<128>(dtype, q, k, v, out, B, S, T, H, KV, causal, window, scale, s);
    case 256: return dispatch<256>(dtype, q, k, v, out, B, S, T, H, KV, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
