// Hopper (sm_90a) kernel for the RWKV-6 chunked WKV recurrence.  Plain C
// entry point, bound with ctypes by ../kernel.py; it returns
// cudaGetLastError().
//
// Replaces (reference package, Pallas on TPU):
//   wkv6 <- repro/kernels/wkv6/kernel.py::wkv6
//
// The function: r, k, v, logw (B, T, H, N), u (H, N), an optional initial
// state s0 (B, H, N, N) f32.  Per (batch, head) an N x N f32 state S (key
// rows, value columns) runs over chunks of C steps; with L the per-channel
// cumulative log-decay inside the chunk (L_{t-1} = L_t - logw_t) and
// mx = max_t(-L_t):
//   scores[t][i] = sum_n r[t][n] e^{clamp(L_{t-1}[n] - mx[n])}
//                        * k[i][n] e^{clamp(mx[n] - L_i[n])},  i < t only
//   o[t] = sum_i scores[t][i] v[i] + (sum_n r u k)[t] v[t]
//          + (r[t] e^{L_{t-1}}) S
//   S'   = diag(e^{L_C}) S + sum_i (k[i] e^{L_C - L_i})^T v[i]
// with each clamp to [-85, 85], exactly where the reference clamps.  All
// arithmetic is f32 with the exact expf (no fast math); out is written in
// r's type (f32 or bf16), the final state in f32.
//
// What bounds it on an H100: operations.  One rwkv6-7b prefill layer
// (B 8, T 4096, H 64, N 64, chunk 64) needs 51.3 GFLOP on the live strictly
// lower score triangle plus the two state products, 0.765 ms at the f32
// rate outside the tensor cores (67 TFLOP/s), against 1.62 GB of r, k, v
// (bf16), logw (f32), out and the state, 0.483 ms at 3.35 TB/s.
//
// Design.  The TPU kernel carries S in VMEM scratch across the sequential
// chunk axis of its grid; here blocks run in parallel and carry nothing,
// so one block owns one (batch, head) and loops over the chunks itself,
// with S in shared memory.  Each chunk's r, k, v and logw tiles are read
// by stride straight from the (B, T, H, N) layout (no transpose copies)
// and converted to f32 into shared memory, rows padded by 4 floats so the
// float4 reads below fall on distinct banks.  The ragged last chunk and a
// head size below 64 are masked in the load: missing rows and channels
// are zero with logw = 0, which is the reference's zero padding, so they
// add nothing and S carries through them unchanged.  Per chunk:
//   1. one thread a channel takes the cumulative sum, its max and L_C,
//      while other threads take the u bonus of each row;
//   2. all threads form the four decayed factors in place;
//   3. scores: each thread owns 4 rows x 4 keys of the 64 x 64 score tile
//      (rows ty + 16j, keys tx + 16j, so a warp's float4 reads hit 8
//      distinct rows on distinct banks), 16 FMAs per two 128-bit loads,
//      masked to the strict lower triangle;
//   4. o: 4 rows x 4 value columns a thread, over the scores then over S;
//   5. S: 4 key rows x 4 value columns a thread, rescaled and updated.
// Six 64 x 68 f32 tiles, 105,472 bytes of dynamic shared memory, so two
// blocks of 256 threads fit an SM.  At the path's shape B * H = 512 blocks
// make about two waves on 132 SMs.  Later work: split T across blocks
// (a two-pass chunk-state scan) and run the products on tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;                 // chunk rows a tile holds (chunk <= 64)
constexpr int kN = 64;                 // channels a tile holds (N <= 64)
constexpr int kLd = kN + 4;            // padded row stride of every tile
constexpr int kTile = kC * kLd;
constexpr size_t kSmem = (6 * kTile + 2 * kN + 2 * kC) * sizeof(float);
constexpr float kClamp = 85.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clampf(float x) {
  return fminf(fmaxf(x, -kClamp), kClamp);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int64_t Tlen,
            int H, int N, int C) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);  // r -> rd -> the scores
  float* K = R + kTile;                        // k -> kd
  float* V = K + kTile;                        // v
  float* Lc = V + kTile;                       // logw -> L -> k e^{L_C - L}
  float* P = Lc + kTile;                       // L_{t-1} -> r e^{L_{t-1}}
  float* S = P + kTile;                        // the state [key][value]
  float* mx = S + kTile;                       // max_t -L_t per channel
  float* lc = mx + kN;                         // L_C per channel
  float* diag = lc + kN;                       // sum_n r u k per row
  float* us = diag + kC;                       // u of this head

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int64_t step = (int64_t)H * N;                  // t -> t + 1
  const int64_t base = (bh / H) * Tlen * step + (int64_t)h * N;
  const int n4 = (N + 3) & ~3;

  for (int e = tid; e < kN * kN; e += kThreads) {
    const int n = e / kN, m = e % kN;
    S[n * kLd + m] =
        (s0 != nullptr && n < N && m < N) ? s0[(bh * N + n) * N + m] : 0.0f;
  }
  if (tid < kN) us[tid] = tid < N ? u[(int64_t)h * N + tid] : 0.0f;

  for (int64_t t0 = 0; t0 < Tlen; t0 += C) {
    const int64_t left = Tlen - t0;
    const int rows = (int)(left < C ? left : C);
    const int rows4 = (rows + 3) & ~3;
    __syncthreads();  // the last chunk's readers are done with the tiles
    for (int e = tid; e < kC * kN; e += kThreads) {
      const int t = e / kN, n = e % kN;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 0.0f;
      if (t < rows && n < N) {
        const int64_t g = base + (t0 + t) * step + n;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        wv = logw[g];
      }
      R[t * kLd + n] = rv;
      K[t * kLd + n] = kv;
      V[t * kLd + n] = vv;
      Lc[t * kLd + n] = wv;
    }
    __syncthreads();

    // 1. the cumulative log-decay (one thread a channel) and the u bonus
    if (tid < kN) {
      const int n = tid;
      float acc = 0.0f, m = -3.402823466e38f;
      for (int t = 0; t < rows; ++t) {
        const float w = Lc[t * kLd + n];
        acc += w;
        Lc[t * kLd + n] = acc;
        P[t * kLd + n] = acc - w;
        m = fmaxf(m, -acc);
      }
      for (int t = rows; t < kC; ++t) {   // padding: r = k = 0 there
        Lc[t * kLd + n] = 0.0f;
        P[t * kLd + n] = 0.0f;
      }
      mx[n] = m;
      lc[n] = acc;
    } else if (tid < kN + kC) {
      const int t = tid - kN;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n)
        acc += R[t * kLd + n] * us[n] * K[t * kLd + n];
      diag[t] = acc;
    }
    __syncthreads();

    // 2. the decayed factors, in place
    for (int e = tid; e < kC * kN; e += kThreads) {
      const int i = (e / kN) * kLd + e % kN, n = e % kN;
      const float rr = R[i], kk = K[i], lcum = Lc[i], lp = P[i], m = mx[n];
      R[i] = rr * expf(clampf(lp - m));
      P[i] = rr * expf(lp);
      K[i] = kk * expf(clampf(-lcum + m));
      Lc[i] = kk * expf(lc[n] - lcum);
    }
    __syncthreads();

    // 3. scores[t][i] = rd[t] . kd[i] for i < t; rows ty + 16a, keys tx + 16c
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
      for (int n = 0; n < n4; n += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = ld4(R + (ty + 16 * a) * kLd + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = ld4(K + (tx + 16 * c) * kLd + n);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] += x[a].x * y[c].x + x[a].y * y[c].y +
                         x[a].z * y[c].z + x[a].w * y[c].w;
      }
      __syncthreads();  // every rd read before the scores overwrite it
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = ty + 16 * a, i = tx + 16 * c;
          R[t * kLd + i] = i < t ? acc[a][c] : 0.0f;
        }
    }
    __syncthreads();

    // 4. o = scores v + rp S + diag v; rows ty + 16a, columns 4tx..4tx+3
    {
      float o[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) o[a][q] = 0.0f;
      const int col = 4 * tx;
      for (int i = 0; i < rows4; i += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = ld4(R + (ty + 16 * a) * kLd + i);
#pragma unroll
        for (int q = 0; q < 4; ++q) y[q] = ld4(V + (i + q) * kLd + col);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          o[a][0] += x[a].x * y[0].x + x[a].y * y[1].x + x[a].z * y[2].x +
                     x[a].w * y[3].x;
          o[a][1] += x[a].x * y[0].y + x[a].y * y[1].y + x[a].z * y[2].y +
                     x[a].w * y[3].y;
          o[a][2] += x[a].x * y[0].z + x[a].y * y[1].z + x[a].z * y[2].z +
                     x[a].w * y[3].z;
          o[a][3] += x[a].x * y[0].w + x[a].y * y[1].w + x[a].z * y[2].w +
                     x[a].w * y[3].w;
        }
      }
      for (int n = 0; n < n4; n += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = ld4(P + (ty + 16 * a) * kLd + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) y[q] = ld4(S + (n + q) * kLd + col);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          o[a][0] += x[a].x * y[0].x + x[a].y * y[1].x + x[a].z * y[2].x +
                     x[a].w * y[3].x;
          o[a][1] += x[a].x * y[0].y + x[a].y * y[1].y + x[a].z * y[2].y +
                     x[a].w * y[3].y;
          o[a][2] += x[a].x * y[0].z + x[a].y * y[1].z + x[a].z * y[2].z +
                     x[a].w * y[3].z;
          o[a][3] += x[a].x * y[0].w + x[a].y * y[1].w + x[a].z * y[2].w +
                     x[a].w * y[3].w;
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty + 16 * a;
        if (t >= rows) continue;
        const float d = diag[t];
        const float4 vt = ld4(V + t * kLd + col);
        const float res[4] = {o[a][0] + d * vt.x, o[a][1] + d * vt.y,
                              o[a][2] + d * vt.z, o[a][3] + d * vt.w};
        T* dst = out + base + (t0 + t) * step;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < N) dst[col + q] = from_f32<T>(res[q]);
      }
    }
    __syncthreads();  // every read of S before it is updated

    // 5. S = diag(e^{L_C}) S + kdecay^T v; key rows 4ty.., value cols 4tx..
    {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
      for (int i = 0; i < rows; ++i) {
        const float4 x = ld4(Lc + i * kLd + 4 * ty);
        const float4 y = ld4(V + i * kLd + 4 * tx);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] += xs[j] * y.x;
          acc[j][1] += xs[j] * y.y;
          acc[j][2] += xs[j] * y.z;
          acc[j][3] += xs[j] * y.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * ty + j;
        const float d = expf(lc[n]);
        float4* sp = reinterpret_cast<float4*>(S + n * kLd + 4 * tx);
        float4 s = *sp;
        s.x = d * s.x + acc[j][0];
        s.y = d * s.y + acc[j][1];
        s.z = d * s.z + acc[j][2];
        s.w = d * s.w + acc[j][3];
        *sp = s;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += kThreads) {
    const int n = e / N, m = e % N;
    s_out[bh * N * N + e] = S[n * kLd + m];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_out, int64_t B,
           int64_t T_, int64_t H, int64_t N, int64_t C, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<T><<<(unsigned int)(B * H), kThreads, kSmem, s>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)s0, (T*)out, (float*)s_out, T_, (int)H,
      (int)N, (int)C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and out).  r, k, v, logw, out
// (B, T, H, N); logw f32; u (H, N) f32; s0 (B, H, N, N) f32 or null (zeros);
// s_out (B, H, N, N) f32.  1 <= N <= 64 and 1 <= C <= 64, C = min(chunk, T).
int wkv6(int dtype, const void* r, const void* k, const void* v,
         const void* logw, const void* u, const void* s0, void* out,
         void* s_out, int64_t B, int64_t T, int64_t H, int64_t N, int64_t C,
         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N < 1 || N > kN || C < 1 || C > kC) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch<float>(r, k, v, logw, u, s0, out, s_out, B, T, H, N, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, logw, u, s0, out, s_out, B, T, H,
                                 N, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
