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
// with each clamp to [-85, 85], exactly where the reference clamps.  The
// exponentials are the exact expf (no fast math); out is written in r's
// type (f32 or bf16), the final state in f32.
//
// What bounds it on an H100: bytes.  One rwkv6-7b prefill layer (B 8,
// T 4096, H 64, N 64, chunk 64) reads r, k, v (bf16) and logw (f32) and
// writes out (bf16) and the state, 1.62 GB: 0.483 ms at 3.35 TB/s.  Its
// 51.3 GFLOP on the live strictly lower score triangle plus the two state
// products take 0.104 ms at the 495 TFLOP/s TF32 tensor-core rate, or
// 0.31 ms at a third of that for the three passes of 3xTF32.
//
// Four things hold back a direct port (every product on the CUDA cores in
// f32, scalar loads between barriers, one thread a channel for the
// prefix, four expf an element between barriers); what this design does
// about each:
//   - The products run on the tensor cores as mma.sync m16n8k8 TF32 with
//     f32 accumulation, in the 3xTF32 form: each f32 operand is split as
//     hi = x rounded to TF32, lo = x - hi (exact in f32; the tensor cores
//     read its top 19 bits), and each product taken as lo hi + hi lo + hi
//     hi, the two small terms in an accumulator of their own.  A bf16 v is
//     exact in TF32, so a product with v as the B operand takes two passes.
//     The split is two integer operations and a subtraction (cvt.rna.tf32
//     expands to four instructions on sm_90).
//   - Loads: a two-stage cp.async ring.  Chunk c+1's raw r, k, v and logw
//     are copied into the free stage with 16-byte cp.async (a bf16 row of
//     64 channels is 8 copies, an f32 row 16) while chunk c computes.
//     Missing rows (the ragged last chunk) and channels (N < 64) are zero-
//     filled by the copy (src-size 0), the reference's zero padding with
//     logw = 0.  Where N or a pointer forbids 16-byte copies (N * sizeof(r)
//     not a multiple of 16), the stage is filled by scalar loads instead.
//   - The decay prefix is spread across the block: a thread owns two
//     channels and 8 consecutive rows (8 lanes a channel pair), sums its
//     segment, takes the segments' exclusive scan with three shuffles,
//     walks its rows again for L, L_{t-1} and the max of -L (three more),
//     and L_C comes from the last segment's lane.  The same thread forms
//     its rows of the four factors and its terms of the u bonus.
//   - Exponentials: the exact expf (no fast math), four an element where a
//     clamp can act; where a channel's |L| stays within 40 over the chunk,
//     no clamp can act (every exponent lies within [-80, 80]), and the
//     factors are products of two exact exponentials an element and three
//     a channel (r e^{L_{t-1} - mx} = (r e^{L_{t-1}}) e^{-mx}, k e^{mx - L}
//     and k e^{L_C - L} from k e^{-L}), a few ulp from the reference's.
// The score factors are stored scaled by 2^64 (r side) and 2^-64 (k side),
// exact in f32: the scores are unchanged, and no operand of the tensor
// cores is subnormal in the clamp regime, where r e^{-85} is.
//
// One block of 8 warps owns one (batch, head) and loops over the chunks
// (the TPU kernel's sequential grid axis), with S in shared memory.  Per
// chunk, after the prefix: warps 2g and 2g+1 own the 16-row strip m (m =
// 0, 1, 3, 2 for g = 0..3, so each SMSP, warp % 4, takes 512-528 mma a
// chunk).  Of the 4 x 4 grid of 16 x 16 score tiles only the 10 on or
// below the diagonal are computed, warp h taking the key tiles j = h, h+2,
// ... <= m in one pass over the channels; each stays in registers (its
// accumulator fragment is the A fragment of scores v with the k slots
// permuted: slot tig <-> key 2 tig, slot tig+4 <-> key 2 tig+1), the
// diagonal tile masked by a select after the product (never a multiply by
// a 0/1 mask, which would turn an inf or NaN of a masked product into
// NaN: a factor k e^{85} overflows f32 for |k| > 41).  Each warp also
// takes a share of the channels of (r e^{L_{t-1}}) S, 16 fewer where it
// has one tile more; warp 2g+1 leaves its partial o in shared memory (the
// consumed r/k stage) and warp 2g adds it, the u bonus times v, and stores
// the rows.  Then kdecay^T v goes into registers (each warp a 16 x 32 tile
// of S, no barrier before it) and, after a barrier, S = diag(e^{L_C}) S +
// kdecay^T v.
//
// Shared memory: the two stages, the r and k score factors, k e^{L_C - L}
// (r e^{L_{t-1}} overwrites logw in its stage), S and small vectors:
// 165,584 bytes for bf16 r/k/v and 214,736 for f32, so one block of 256
// threads fits an SM; at the path's shape B * H = 512 blocks make 3.88
// waves (4 rounds) on 132 SMs.  f32 rows are padded to 68 floats where
// fragments read along rows and to 72 where they read down columns (k e^..
// and S), and every 8 rows are shifted by 16 more bytes, so the fragment
// loads and the prefix's (channel pair, segment) accesses fall on distinct
// banks.  What bounds it now (PERF.md; chip_smoke.py's "wkv6 parts"):
// about a quarter of its time is the prefix and the exponentials, which no
// other block on the SM overlaps, and mma.sync TF32 runs at about 320
// TFLOP/s on an H100, so its products alone take about 0.43 ms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kC = 64;                 // chunk rows a tile holds (chunk <= 64)
constexpr int kN = 64;                 // channels a tile holds (N <= 64)
constexpr int kLdA = 68;               // f32 tiles read along rows (4 mod 32)
constexpr int kLdB = 72;               // f32 tiles read down columns
// every 8 rows of a tile are shifted by 16 more bytes
template <typename E> __host__ __device__ constexpr int skew() {
  return 16 / (int)sizeof(E);
}
constexpr int kTileA = kC * kLdA + 7 * skew<float>();   // floats
constexpr int kTileB = kC * kLdB + 7 * skew<float>();
constexpr float kClamp = 85.0f;
// a channel whose |L| stays within this over a chunk has every exponent
// within [-80, 80]: no clamp acts, no exponential is subnormal or inf
constexpr float kNear = 40.0f;
constexpr float kUp = 18446744073709551616.0f;        // 2^64
constexpr float kDown = 5.42101086242752217e-20f;     // 2^-64

// row t of a tile of elements E and row stride ld
template <typename E = float>
__device__ __forceinline__ int row_off(int t, int ld) {
  return t * ld + (t >> 3) * skew<E>();
}

// the staged r, k, v tiles: bf16 rows of 72 (36 words, 4 mod 32)
template <typename T> struct In { static constexpr int ld = kLdA; };
template <> struct In<__nv_bfloat16> { static constexpr int ld = 72; };
template <typename T> __host__ __device__ constexpr int in_tile() {
  return kC * In<T>::ld + 7 * skew<T>();
}
template <typename T> __host__ __device__ constexpr size_t stage_bytes() {
  return 3 * in_tile<T>() * sizeof(T) + kTileA * sizeof(float);
}
template <typename T> __host__ __device__ constexpr size_t smem_bytes() {
  return 2 * stage_bytes<T>() +
         (2 * kTileA + kTileB + kC * kLdB + 8 * kC + 2 * kN) * sizeof(float);
}
static_assert(stage_bytes<float>() % 16 == 0 &&
                  stage_bytes<__nv_bfloat16>() % 16 == 0 &&
                  (in_tile<__nv_bfloat16>() * 2) % 16 == 0,
              "16-byte aligned stages");
// the partial o of phase 2 fits the consumed r and k tiles of its stage
static_assert(2 * in_tile<__nv_bfloat16>() * 2 >= kTileA * 4 &&
                  in_tile<float>() * 4 >= kTileA * 4,
              "partial o in the r/k tiles");
static_assert(smem_bytes<float>() <= 232448, "fits one block an SM");

// a pair of adjacent channels of r or k
template <typename T> struct Pair { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_f2(float2 x) { return x; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
// two adjacent outputs, 4- (bf16) or 8-byte (f32) aligned
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// the 64 threads of warps 2g and 2g+1
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: half the weight of the low 13 bits added, then
// those bits cleared), lo = x - hi exactly in f32; the tensor cores read
// lo's top 19 bits (it is truncated to TF32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Fragment layouts of mma.m16n8k8 TF32 (lane = 4 * gid + tig): A a[0..3]
// is (row gid, k tig), (row gid + 8, k tig), (row gid, k tig + 4), (row
// gid + 8, k tig + 4); B b0, b1 (k tig, col gid), (k tig + 4, col gid);
// the f32 accumulator c[0..1] (row gid, cols 2 tig + {0, 1}), c[2..3] the
// same of row gid + 8.
struct Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void split4(Frag& f, float a0, float a1, float a2,
                                       float a3) {
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
}

// c (16 x 8 f32) += a (16 x 8, row) * b (8 x 8, col), one TF32 pass
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: a b as lo hi + hi lo (into cl) + hi hi (into ch); ch and cl
// may be one accumulator, or two that shorten the chain of dependent mma
__device__ __forceinline__ void mma3(float (&ch)[4], float (&cl)[4],
                                     const Frag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(cl, a.lo, h0, h1);
  mma_tf32(cl, a.hi, l0, l1);
  mma_tf32(ch, a.hi, h0, h1);
}
// b a value of v: a bf16 is exact in TF32, so two passes; f32 three
template <typename T>
__device__ __forceinline__ void mma_v(float (&ch)[4], float (&cl)[4],
                                      const Frag& a, T b0, T b1) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t x0 = __float_as_uint(to_f32(b0));
    const uint32_t x1 = __float_as_uint(to_f32(b1));
    mma_tf32(cl, a.lo, x0, x1);
    mma_tf32(ch, a.hi, x0, x1);
  } else {
    mma3(ch, cl, a, to_f32(b0), to_f32(b1));
  }
}

// Chunk rows [t0, t0 + rows) of one (batch, head) into a stage; g0 the
// offset of row t0, channel 0.
template <typename T>
__device__ __forceinline__ void load_chunk(
    unsigned char* stage, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw, int64_t g0,
    int64_t step, int rows, int N, bool vec, int tid) {
  constexpr int ld = In<T>::ld, tile = in_tile<T>();
  T* R = reinterpret_cast<T*>(stage);
  T* K = R + tile;
  T* V = K + tile;
  float* W = reinterpret_cast<float*>(V + tile);
  if (vec) {
    constexpr int E = 16 / sizeof(T);          // elements a copy
    constexpr int CPR = kN / E;                // copies a row
    for (int e = tid; e < kC * CPR; e += kThreads) {
      const int t = e / CPR, n = (e % CPR) * E;
      const bool ok = t < rows && n < N;
      const int64_t g = ok ? g0 + t * step + n : 0;
      const int o = row_off<T>(t, ld) + n;
      cp_async16(R + o, r + g, ok);
      cp_async16(K + o, k + g, ok);
      cp_async16(V + o, v + g, ok);
    }
    for (int e = tid; e < kC * (kN / 4); e += kThreads) {
      const int t = e / (kN / 4), n = (e % (kN / 4)) * 4;
      const bool ok = t < rows && n < N;
      const int64_t g = ok ? g0 + t * step + n : 0;
      cp_async16(W + row_off(t, kLdA) + n, logw + g, ok);
    }
  } else {
    for (int e = tid; e < kC * kN; e += kThreads) {
      const int t = e / kN, n = e % kN;
      const bool ok = t < rows && n < N;
      const int64_t g = g0 + t * step + n;
      const int o = row_off<T>(t, ld) + n;
      R[o] = ok ? r[g] : zero<T>();
      K[o] = ok ? k[g] : zero<T>();
      V[o] = ok ? v[g] : zero<T>();
      W[row_off(t, kLdA) + n] = ok ? logw[g] : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int64_t Tlen,
            int H, int N, int C, int vec) {
  constexpr int ldT = In<T>::ld, tileT = in_tile<T>();
  constexpr size_t kStage = stage_bytes<T>();
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* RD = reinterpret_cast<float*>(sm + 2 * kStage);  // r e^{..} 2^64
  float* KD = RD + kTileA;                 // k e^{..} 2^-64
  float* KC = KD + kTileA;                 // k e^{L_C - L}, stride kLdB
  float* S = KC + kTileB;                  // the state [key][value], kLdB
  float* diagp = S + kC * kLdB;            // u bonus, per warp and row
  float* ec = diagp + 8 * kC;              // e^{L_C} per channel
  float* us = ec + kN;                     // u of this head

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int64_t step = (int64_t)H * N;                  // t -> t + 1
  const int64_t base = (bh / H) * Tlen * step + (int64_t)h * N;
  const int nc = (int)((Tlen + C - 1) / C);

  for (int e = tid; e < kN * kN; e += kThreads) {
    const int n = e / kN, m = e % kN;
    S[n * kLdB + m] =
        (s0 != nullptr && n < N && m < N) ? s0[(bh * N + n) * N + m] : 0.0f;
  }
  if (tid < kN) us[tid] = tid < N ? u[(int64_t)h * N + tid] : 0.0f;

  load_chunk<T>(sm, r, k, v, logw, base, step, (int)(Tlen < C ? Tlen : C),
                N, vec, tid);
  cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const int64_t t0 = (int64_t)c * C;
    const int64_t left = Tlen - t0;
    const int rows = (int)(left < C ? left : C);
    __syncthreads();  // chunk c-1 is done with the other stage and with S
    if (c + 1 < nc) {
      const int64_t left1 = left - C;
      load_chunk<T>(sm + ((c + 1) & 1) * kStage, r, k, v, logw,
                    base + (t0 + C) * step, step,
                    (int)(left1 < C ? left1 : C), N, vec, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // chunk c has landed, every thread's copies

    unsigned char* stage = sm + (c & 1) * kStage;
    const T* Rin = reinterpret_cast<const T*>(stage);
    const T* Kin = Rin + tileT;
    const T* Vin = Kin + tileT;
    float* W = reinterpret_cast<float*>(stage + 3 * tileT * sizeof(T));
    float* Ob = reinterpret_cast<float*>(stage);   // over consumed r and k

    // 1. the decay prefix and the factors: channels n, n + 1, rows
    //    8 seg + i
    {
      using P = typename Pair<T>::type;
      const int n = 8 * warp + 2 * (lane >> 3), seg = lane & 7;
      float2 w[8], L[8];
      float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        w[i] = *reinterpret_cast<const float2*>(
            W + row_off(8 * seg + i, kLdA) + n);
        s.x += w[i].x;
        s.y += w[i].y;
      }
      float2 y;                             // inclusive scan of 8 segments
#pragma unroll
      for (int d = 1; d < 8; d *= 2) {
        y.x = __shfl_up_sync(0xffffffffu, s.x, d, 8);
        y.y = __shfl_up_sync(0xffffffffu, s.y, d, 8);
        if (seg >= d) {
          s.x += y.x;
          s.y += y.y;
        }
      }
      y.x = __shfl_up_sync(0xffffffffu, s.x, 1, 8);
      y.y = __shfl_up_sync(0xffffffffu, s.y, 1, 8);
      float2 acc = seg == 0 ? make_float2(0.0f, 0.0f) : y;  // rows before
      float2 mx = make_float2(-3.402823466e38f, -3.402823466e38f);
      float big = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc.x += w[i].x;
        acc.y += w[i].y;
        L[i] = acc;
        mx.x = fmaxf(mx.x, -acc.x);
        mx.y = fmaxf(mx.y, -acc.y);
        big = fmaxf(big, fmaxf(fabsf(acc.x), fabsf(acc.y)));
      }
#pragma unroll
      for (int d = 1; d < 8; d *= 2) {
        mx.x = fmaxf(mx.x, __shfl_xor_sync(0xffffffffu, mx.x, d));
        mx.y = fmaxf(mx.y, __shfl_xor_sync(0xffffffffu, mx.y, d));
        big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, d));
      }
      const float2 lc =                                       // L_C
          make_float2(__shfl_sync(0xffffffffu, acc.x, lane | 7),
                      __shfl_sync(0xffffffffu, acc.y, lane | 7));
      const float2 un = *reinterpret_cast<const float2*>(us + n);
      float d[8];
      if (big <= kNear) {
        // no clamp can act and no exponential leaves the normal range: a
        // factor is a product of exact exponentials, two an element
        const float2 er = make_float2(expf(-mx.x) * kUp, expf(-mx.y) * kUp);
        const float2 ek =
            make_float2(expf(mx.x) * kDown, expf(mx.y) * kDown);
        const float2 el = make_float2(expf(lc.x), expf(lc.y));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = 8 * seg + i;
          const int ia = row_off(t, kLdA) + n;
          const float2 rr = to_f2(
              *reinterpret_cast<const P*>(Rin + row_off<T>(t, ldT) + n));
          const float2 kk = to_f2(
              *reinterpret_cast<const P*>(Kin + row_off<T>(t, ldT) + n));
          const float2 rp = make_float2(rr.x * expf(L[i].x - w[i].x),
                                        rr.y * expf(L[i].y - w[i].y));
          const float2 ke = make_float2(kk.x * expf(-L[i].x),
                                        kk.y * expf(-L[i].y));
          *reinterpret_cast<float2*>(RD + ia) =
              make_float2(rp.x * er.x, rp.y * er.y);
          *reinterpret_cast<float2*>(KD + ia) =
              make_float2(ke.x * ek.x, ke.y * ek.y);
          *reinterpret_cast<float2*>(W + ia) = rp;        // over logw
          *reinterpret_cast<float2*>(KC + row_off(t, kLdB) + n) =
              make_float2(ke.x * el.x, ke.y * el.y);
          d[i] = rr.x * un.x * kk.x + rr.y * un.y * kk.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = 8 * seg + i;
          const int ia = row_off(t, kLdA) + n;
          const float2 rr = to_f2(
              *reinterpret_cast<const P*>(Rin + row_off<T>(t, ldT) + n));
          const float2 kk = to_f2(
              *reinterpret_cast<const P*>(Kin + row_off<T>(t, ldT) + n));
          const float2 lp = make_float2(L[i].x - w[i].x, L[i].y - w[i].y);
          *reinterpret_cast<float2*>(RD + ia) =
              make_float2(rr.x * expf(clampf(lp.x - mx.x)) * kUp,
                          rr.y * expf(clampf(lp.y - mx.y)) * kUp);
          *reinterpret_cast<float2*>(KD + ia) =
              make_float2(kk.x * expf(clampf(-L[i].x + mx.x)) * kDown,
                          kk.y * expf(clampf(-L[i].y + mx.y)) * kDown);
          *reinterpret_cast<float2*>(W + ia) =        // r e^{L_{t-1}}
              make_float2(rr.x * expf(lp.x), rr.y * expf(lp.y));
          *reinterpret_cast<float2*>(KC + row_off(t, kLdB) + n) =
              make_float2(kk.x * expf(lc.x - L[i].x),
                          kk.y * expf(lc.y - L[i].y));
          d[i] = rr.x * un.x * kk.x + rr.y * un.y * kk.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {             // over the warp's 8 channels
        d[i] += __shfl_xor_sync(0xffffffffu, d[i], 8);
        d[i] += __shfl_xor_sync(0xffffffffu, d[i], 16);
      }
      if (lane < 8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) diagp[warp * kC + 8 * seg + i] = d[i];
      }
      if (seg == 0) {
        ec[n] = expf(lc.x);
        ec[n + 1] = expf(lc.y);
      }
    }
    __syncthreads();

    // 2. o of strip m (rows 16m..16m+15) by the pair 2g, 2g+1: warp h
    //    takes the score tiles j = h, h+2, ... <= m and a share of the
    //    channels of rp S, 16 fewer where it has one tile more.  Warp w
    //    runs on SMSP w % 4, so strips 0, 1, 3, 2 for g = 0..3 put strips 0
    //    and 3 on SMSPs 0 and 1, strips 1 and 2 on SMSPs 2 and 3, and all
    //    four take 512-528 mma a chunk
    {
      const int g = warp >> 1, m = g ^ (g >> 1), hp = warp & 1;
      if (16 * m < rows) {
        float o[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
        const int ta = 16 * m + gid, tb = ta + 8;   // the fragment rows
        const int ra = row_off(ta, kLdA) + tig, rb = row_off(tb, kLdA) + tig;
        // the warp's score tiles j = hp + 2 t, t < NJ, in one pass over
        // the channels (each A fragment of rd split once for all of them)
        auto tiles = [&](auto nj_) {
          constexpr int NJ = decltype(nj_)::value;
          float sc[NJ][2][4], sl[NJ][2][4];
#pragma unroll
          for (int t = 0; t < NJ; ++t)
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[t][q][e] = sl[t][q][e] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {   // channels past N are zero
            Frag a;
            split4(a, RD[ra + 8 * kk], RD[rb + 8 * kk], RD[ra + 8 * kk + 4],
                   RD[rb + 8 * kk + 4]);
#pragma unroll
            for (int t = 0; t < NJ; ++t)
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int key = 16 * (hp + 2 * t) + 8 * q + gid;
                const float* pb = KD + row_off(key, kLdA) + 8 * kk + tig;
                mma3(sc[t][q], sl[t][q], a, pb[0], pb[4]);
              }
          }
#pragma unroll
          for (int t = 0; t < NJ; ++t) {
            const int j = hp + 2 * t;
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                sc[t][q][e] += sl[t][q][e];
                if (j == m) {  // keys i < t only, by select after the product
                  const int row = gid + 8 * (e >> 1);
                  const int key = 8 * q + 2 * tig + (e & 1);
                  sc[t][q][e] = key < row ? sc[t][q][e] : 0.0f;
                }
              }
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              // k slot tig <-> key 2 tig, slot tig + 4 <-> key 2 tig + 1
              Frag a;
              split4(a, sc[t][q][0], sc[t][q][2], sc[t][q][1], sc[t][q][3]);
              const T* pv =
                  Vin + row_off<T>(16 * j + 8 * q + 2 * tig, ldT) + gid;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                mma_v<T>(o[nt], o[nt], a, pv[8 * nt], pv[8 * nt + ldT]);
            }
          }
        };
        if (hp + 2 <= m)
          tiles(std::integral_constant<int, 2>());
        else if (hp <= m)
          tiles(std::integral_constant<int, 1>());
        const int ks = (m & 1) ? 4 : 2;     // the pair's split of channels
        const int k0 = hp ? ks : 0, k1 = hp ? 8 : ks;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {             // (r e^{L_{t-1}}) S
          if (kk < k0 || kk >= k1) continue;
          Frag a;
          split4(a, W[ra + 8 * kk], W[rb + 8 * kk], W[ra + 8 * kk + 4],
                 W[rb + 8 * kk + 4]);
          const float* ps = S + (8 * kk + tig) * kLdB + gid;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma3(o[nt], o[nt], a, ps[8 * nt], ps[8 * nt + 4 * kLdB]);
        }
        float* oa = Ob + row_off(ta, kLdA) + 2 * tig;
        float* ob = Ob + row_off(tb, kLdA) + 2 * tig;
        if (hp == 1) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            store2(oa + 8 * nt, o[nt][0], o[nt][1]);
            store2(ob + 8 * nt, o[nt][2], o[nt][3]);
          }
        }
        pair_sync(1 + m);
        if (hp == 0) {
          float da = 0.0f, db = 0.0f;
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            da += diagp[w * kC + ta];
            db += diagp[w * kC + tb];
          }
          const T* va = Vin + row_off<T>(ta, ldT) + 2 * tig;
          const T* vb = Vin + row_off<T>(tb, ldT) + 2 * tig;
          T* dsta = out + base + (t0 + ta) * step;
          T* dstb = out + base + (t0 + tb) * step;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = 8 * nt + 2 * tig;
            const float2 pa = *reinterpret_cast<const float2*>(oa + 8 * nt);
            const float2 pb = *reinterpret_cast<const float2*>(ob + 8 * nt);
            const float a0 = o[nt][0] + pa.x + da * to_f32(va[8 * nt]);
            const float a1 = o[nt][1] + pa.y + da * to_f32(va[8 * nt + 1]);
            const float b0 = o[nt][2] + pb.x + db * to_f32(vb[8 * nt]);
            const float b1 = o[nt][3] + pb.y + db * to_f32(vb[8 * nt + 1]);
            if ((N & 1) == 0) {             // col even, so col + 1 < N
              if (col < N) {
                if (ta < rows) store2(dsta + col, a0, a1);
                if (tb < rows) store2(dstb + col, b0, b1);
              }
            } else {
              if (ta < rows) {
                if (col < N) dsta[col] = from_f32<T>(a0);
                if (col + 1 < N) dsta[col + 1] = from_f32<T>(a1);
              }
              if (tb < rows) {
                if (col < N) dstb[col] = from_f32<T>(b0);
                if (col + 1 < N) dstb[col + 1] = from_f32<T>(b1);
              }
            }
          }
        }
      }
    }
    // 3. kdecay^T v into registers, S untouched: key rows 16 ms.., value
    //    columns c0 + 8 nt.. (A = kdecay^T read down the columns of KC);
    //    it needs no barrier after phase 2, so it fills phase 2's uneven
    //    end
    const int ms = warp >> 1, c0 = 32 * (warp & 1);
    float acc[4][4], acl[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = acl[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {          // rows past the chunk are zero
      const float* pa = KC + row_off(8 * kk + tig, kLdB) + 16 * ms + gid;
      const float* pa4 = pa + 4 * kLdB;                 // same 8-row block
      Frag a;
      split4(a, pa[0], pa[8], pa4[0], pa4[8]);
      const T* pv = Vin + row_off<T>(8 * kk + tig, ldT) + c0 + gid;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_v<T>(acc[nt], acl[nt], a, pv[8 * nt], pv[8 * nt + 4 * ldT]);
    }
    __syncthreads();  // every read of S before it is updated

    // 4. S = diag(e^{L_C}) S + kdecay^T v
    {
      const int na = 16 * ms + gid, nb = na + 8;
      const float ea = ec[na], eb = ec[nb];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c0 + 8 * nt + 2 * tig;
        float2* sa = reinterpret_cast<float2*>(S + na * kLdB + col);
        float2* sb = reinterpret_cast<float2*>(S + nb * kLdB + col);
        float2 x = *sa, y = *sb;
        x.x = ea * x.x + (acc[nt][0] + acl[nt][0]);
        x.y = ea * x.y + (acc[nt][1] + acl[nt][1]);
        y.x = eb * y.x + (acc[nt][2] + acl[nt][2]);
        y.y = eb * y.y + (acc[nt][3] + acl[nt][3]);
        *sa = x;
        *sb = y;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += kThreads) {
    const int n = e / N, m = e % N;
    s_out[bh * N * N + e] = S[n * kLdB + m];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, void* out, void* s_out, int64_t B,
           int64_t T_, int64_t H, int64_t N, int64_t C, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies need 16-byte rows (bf16 N % 8, f32 N % 4) and pointers
  const int vec = (N * (int64_t)sizeof(T)) % 16 == 0 && aligned16(r) &&
                  aligned16(k) && aligned16(v) && aligned16(logw);
  wkv6_kernel<T><<<(unsigned int)(B * H), kThreads, smem, s>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)logw,
      (const float*)u, (const float*)s0, (T*)out, (float*)s_out, T_, (int)H,
      (int)N, (int)C, vec);
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
