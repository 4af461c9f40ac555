// Hopper (sm_90a) forward kernel for causal (or full) GQA softmax attention
// with an optional sliding window, online softmax over key tiles.  Plain C
// entry point, bound with ctypes by ../kernel.py; it returns
// cudaGetLastError().
//
// Replaces (reference package, Pallas on TPU):
//   flash_attention <- repro/kernels/flash_attention/kernel.py::flash_attention
//
// The function: q (B, S, H, D), k and v (B, T, KV, D), H = KV * G, query
// head h = kv * G + g reads key head kv.  Query s sees key t when t <= s
// (causal) and t > s - window (window > 0).  Scores, softmax and p @ v are
// f32 whatever the input type (f32 or bf16); the output is in q's type.  A
// masked score is -1e30, as in the TPU kernel, and a key tile that every
// row of a block masks is skipped.
//
// What bounds it on an H100: about 4 * D operations per (query row, live
// key) pair against a few hundred MB of q, k, v and out, so operations
// bound it.  At recurrentgemma-2b's prefill shape (B 8, S 4096, H 10, KV 1,
// D 256, window 2048) that is 5.15e11 operations: 0.52 ms at the bf16
// tensor-core peak, 7.7 ms at the f32 rate outside the tensor cores.  This
// kernel computes in f32 on the CUDA cores (no tensor cores, no wgmma, no
// TMA: those are for a later redesign), so the f32 rate is its own ceiling.
//
// Design.  The TPU kernel carries (m, l, acc) across the kv axis of its
// grid in VMEM; here blocks run in parallel, so one block takes one
// (batch * kv head, tile of kRows query rows) and loops over the key tiles
// itself.  Rows are the TPU kernel's: row = s * G + g of one (batch, kv
// head), so the G query heads that share a key head share the block's key
// tiles.  The block's q rows and each key tile's K and V rows are converted
// to f32 once into shared memory (rows padded by 4 floats, so the float4
// reads below fall on distinct banks).  A key tile is two register-tiled
// products, as in a CUDA-core matrix multiply:
//   scores: each thread owns 4 rows x 4 keys of the 64 x 64 score tile, so
//     every float4 of q or K it reads from shared memory feeds 4 rows or 4
//     keys (16 FMAs per two 128-bit loads);
//   softmax: 4 threads a row take the row's maximum and sum with two xor
//     shuffles, keep m and l in registers, and leave p and the rescale
//     factor in shared memory;
//   p @ v: each thread owns RPT rows x (C float4 columns) of the output
//     accumulator in registers (4 x 16 floats at D = 256), so every float4
//     of V it reads feeds RPT rows.
// The block visits only the key tiles that some row of it can see, and
// masks the ragged edges (window start, causal end, T) itself, with no
// padding copies.
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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int S, int T_, int H, int KV, int D, int causal, int window,
               float scale, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, T_, H, KV, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, T_, H, KV, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, T_, H, KV, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, T_, H, KV, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, B, S, T, H, KV, D, causal, window,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, D, causal,
                                     window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
