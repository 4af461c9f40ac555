// Hopper (sm_90a) kernels for the EDST tree collectives: the multi-child
// partial-sum combine and the int8 wire codec.  Plain C entry points, bound
// with ctypes by ../kernel.py; each returns cudaGetLastError().
//
// Replaces (reference package, Pallas on TPU):
//   tree_combine     <- repro/kernels/tree_combine/kernel.py::tree_combine
//   q8_pack_rows     <- repro/kernels/tree_combine/kernel.py::q8_pack_wire
//                       (and its vmap over rows, ops.py::q8_pack_rows)
//   q8_combine_rows  <- repro/kernels/tree_combine/kernel.py::q8_combine_wire
//   q8_unpack_rows   <- repro/kernels/tree_combine/kernel.py::q8_unpack_wire
//                       (and its vmap over rows, ops.py::q8_unpack_rows)
//
// What bounds them on an H100: all four are pure streaming passes with
// O(1) operations per element, so the bound is the bytes moved over the
// 3.35 TB/s of HBM3.  On the training path each call streams a stacked
// (16 or 32 rows) x 67M-lane buffer, far beyond the 50 MB L2, so nothing
// is reused across calls.
//
// tree_combine (on the path: one child, 1,076,120,064 f32, 12.9 GB moved,
// 3.85 ms at the HBM rate) keeps enough bytes in flight to cover HBM's
// latency: 16-byte loads and stores (float4, or 8 bf16 / f16 as uint4),
// four independent vectors per thread, all loaded before any add, and
// streaming cache hints (__ldcs / __stcs: the stream reuses nothing in
// L2).  The grid passes over the data once, each block one contiguous
// run of 256 x 4 vectors, so the blocks in flight stream through memory
// in address order: on an H100 this kernel as a persistent grid-stride
// loop of 1, 2 or 4 (its occupancy) blocks an SM was 3-4% slower than
// torch.add at the path's shape, and this grid is not
// (scripts/tree_combine_grid.py times both).  The vector body
// covers the part where recv's rows, partial and out share 16-byte
// alignment; a scalar head and tail take the rest (any storage offset,
// any length, rows of other alignments).  The one-child case, the
// path's, is its own instance.
//
// The pack (q8_pack_rows) needs a row's absmax before it can write the
// row's first lane: the scale is fixed by the whole row, and the wire must
// stay byte-identical, so no provisional scale.  A row on the path is 269
// or 538 MB, far more than the 50 MB L2, shared memory and registers hold
// together, so any exact design reads x twice: its floor is 2 reads of x
// and 1 write of the wires, (2 * 4 + 1) * rows * m bytes over HBM's rate
// (5.78 ms at (16, 134,515,008)), where the bytes bound (x read once)
// is 3.21 ms.  Two launches, each a pass in the combine's form: 16-byte
// streaming loads (__ldcs), kUnroll independent float4 a thread loaded
// before any use, one block per contiguous run of kThreads * kUnroll
// vectors of a row (rows on gridDim.y), so the grid passes over x once in
// address order.  The absmax pass reduces a block to one value and makes
// one atomicMax on the float's bits (which order like the value for
// non-negative floats) per block; the quantize pass turns four lanes into
// one 4-byte store.  Each row finds its own 16-byte boundary from its own
// address (with m % 4 != 0 or a storage offset, rows of x differ), block
// 0 of the row takes the at most 3 + 3 scalar lanes before and after the
// vector body, and the 4-byte stores run where the row's wire lanes are
// 4-byte aligned at the body (always on the path: m % 4 == 0, x 16-byte
// aligned), byte stores elsewhere.
//
// The other codec kernels keep one grid-stride loop each, coalesced
// (neighbouring threads on neighbouring addresses), on a 2-D grid of
// (slab, row) so that 16 rows still fill 132 SMs; 16-byte loads and
// stores there (rows of m+4 bytes are not 16-byte aligned, so the simple
// version moves bytes) are later work.
//
// Numerics: the wire must be byte-identical to the plain version, so every
// step is an explicitly rounded intrinsic (no FMA contraction, no fast
// math): scale = absmax * (1/127) + 1e-30, lane = rint(x * (1 / scale)),
// rint rounding half to even like jnp.round / torch.round.  The combine
// sums the children first, from 0 (one child: that child), then adds the
// partial, each add rounded (__fadd_rn): at one child in f32 it is
// partial + recv[0], bit for bit the plain version and torch.add.  Do not
// build with --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // 16 resident-ish blocks per SM
// the reference's (1.0 / 127.0): a double constant rounded to f32
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of T as f32 lanes, and back (each lane rounded to nearest even)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* f) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack16<__half>(const uint4& u, float* f) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

__device__ __forceinline__ unsigned int bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned int bits16(__half x) {
  return __half_as_ushort(x);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bits16(from_f32<T>(f[2 * i])) |
             (bits16(from_f32<T>(f[2 * i + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

constexpr int kUnroll = 4;   // independent 16-byte vectors a thread holds

// out[i] = partial[i] + sum_c recv[c, i], accumulated in f32: the children
// summed first, from 0, then added to the partial, each add rounded.  NCH
// fixes the children count at compile time (1, the path's); NCH == 0
// reads it from nch.  Elements [head, head + nvec * V) go as 16-byte
// vectors (recv's rows, partial and out all 16-byte aligned at head), a
// block's kThreads * kUnroll vectors at a time; the rest one at a time.
template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
tree_combine_kernel(const T* __restrict__ recv, const T* __restrict__ partial,
                    T* __restrict__ out, int64_t nch, int64_t len,
                    int64_t head, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int64_t kPer = (int64_t)kThreads * kUnroll;
  const int64_t n_ch = NCH > 0 ? NCH : nch;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // the scalar head [0, head) and tail [body_end, len)
  const int64_t body_end = head + nvec * V;
  for (int64_t j = tid; j < head + len - body_end; j += threads) {
    const int64_t i = j < head ? j : body_end + (j - head);
    float s = NCH == 1 ? to_f32(recv[i]) : 0.0f;
    if (NCH != 1)
      for (int64_t c = 0; c < n_ch; ++c)
        s = __fadd_rn(s, to_f32(recv[c * len + i]));
    out[i] = from_f32<T>(__fadd_rn(to_f32(partial[i]), s));
  }

  // the vector body: all of a thread's loads issued before any add
  const uint4* pv = reinterpret_cast<const uint4*>(partial + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  for (int64_t start = (int64_t)blockIdx.x * kPer; start < nvec;
       start += (int64_t)gridDim.x * kPer) {
    const int64_t i0 = start + threadIdx.x;
    uint4 pu[kUnroll], ru[kUnroll];
    float s[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      pu[u] = i < nvec ? __ldcs(pv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
    if (NCH == 1) {
      const uint4* rv = reinterpret_cast<const uint4*>(recv + head);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * kThreads;
        ru[u] = i < nvec ? __ldcs(rv + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) unpack16<T>(ru[u], s[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) s[u][e] = 0.0f;
      for (int64_t c = 0; c < n_ch; ++c) {
        const uint4* rv = reinterpret_cast<const uint4*>(recv + c * len + head);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t i = i0 + u * kThreads;
          ru[u] = i < nvec ? __ldcs(rv + i) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float f[V];
          unpack16<T>(ru[u], f);
#pragma unroll
          for (int e = 0; e < V; ++e) s[u][e] = __fadd_rn(s[u][e], f[e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i >= nvec) continue;
      float f[V];
      unpack16<T>(pu[u], f);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = __fadd_rn(f[e], s[u][e]);
      __stcs(ov + i, pack16<T>(f));
    }
  }
}

// lanes of the row at xr before its first 16-byte boundary (at most m)
__device__ __forceinline__ int64_t row_head(const float* xr, int64_t m) {
  const int64_t h = (4 - (int64_t)(((uintptr_t)xr / sizeof(float)) % 4)) % 4;
  return h < m ? h : m;
}

// the row's scalar lane j of the head [0, head) and tail [head + 4 nvec, m)
__device__ __forceinline__ int64_t scalar_lane(int64_t j, int64_t head,
                                               int64_t nvec) {
  return j < head ? j : head + 4 * nvec + (j - head);
}

__device__ __forceinline__ float absmax4(const float4& v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// one lane: rint(x * inv) as int8, in the low byte
__device__ __forceinline__ unsigned int q8_lane(float v, float inv) {
  return (unsigned int)(uint8_t)(int8_t)(int)rintf(__fmul_rn(v, inv));
}

// per-row max|x| into amax[row] (as float bits; amax zeroed by the caller):
// block (b, row) takes vectors [b, b + 1) * kThreads * kUnroll of the row's
// body, block (0, row) also its scalar head and tail
__global__ void __launch_bounds__(kThreads)
q8_absmax_kernel(const float* __restrict__ x, unsigned int* __restrict__ amax,
                 int64_t m) {
  constexpr int64_t kPer = (int64_t)kThreads * kUnroll;
  const int64_t row = blockIdx.y;
  const float* xr = x + row * m;
  const int64_t head = row_head(xr, m);
  const int64_t nvec = (m - head) / 4;
  float v = 0.0f;
  if (blockIdx.x == 0 && threadIdx.x < m - 4 * nvec)
    v = fabsf(xr[scalar_lane(threadIdx.x, head, nvec)]);
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  const int64_t i0 = (int64_t)blockIdx.x * kPer + threadIdx.x;
  float4 u[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = i0 + k * kThreads;
    u[k] = i < nvec ? __ldcs(xv + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) v = fmaxf(v, absmax4(u[k]));
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) atomicMax(amax + row, __float_as_uint(v));
  }
}

// lanes = rint(x * (1 / scale)) as int8, over the absmax pass's grid;
// block (0, row) also writes the scalar lanes and the scale's 4-byte tail
__global__ void __launch_bounds__(kThreads)
q8_quantize_kernel(const float* __restrict__ x,
                   const unsigned int* __restrict__ amax,
                   int8_t* __restrict__ out, int64_t m) {
  constexpr int64_t kPer = (int64_t)kThreads * kUnroll;
  const int64_t row = blockIdx.y;
  const float scale =
      __fadd_rn(__fmul_rn(__uint_as_float(amax[row]), kInv127), 1e-30f);
  const float inv = __fdiv_rn(1.0f, scale);
  const float* xr = x + row * m;
  int8_t* o = out + row * (m + 4);
  const int64_t head = row_head(xr, m);
  const int64_t nvec = (m - head) / 4;
  if (blockIdx.x == 0) {
    if (threadIdx.x < m - 4 * nvec) {
      const int64_t i = scalar_lane(threadIdx.x, head, nvec);
      o[i] = (int8_t)q8_lane(xr[i], inv);
    }
    if (threadIdx.x < 4) {
      const unsigned int bits = __float_as_uint(scale);
      o[m + threadIdx.x] = (int8_t)((bits >> (8 * threadIdx.x)) & 0xffu);
    }
  }
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  int8_t* ob = o + head;
  const bool words = (uintptr_t)ob % 4 == 0;
  const int64_t i0 = (int64_t)blockIdx.x * kPer + threadIdx.x;
  float4 u[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = i0 + k * kThreads;
    u[k] = i < nvec ? __ldcs(xv + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t i = i0 + k * kThreads;
    if (i >= nvec) continue;
    const unsigned int w = q8_lane(u[k].x, inv) | q8_lane(u[k].y, inv) << 8 |
                           q8_lane(u[k].z, inv) << 16 |
                           q8_lane(u[k].w, inv) << 24;
    if (words) {
      __stcs(reinterpret_cast<unsigned int*>(ob) + i, w);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ob[4 * i + e] = (int8_t)(w >> (8 * e));
    }
  }
}

// the f32 scale in a wire's 4-byte tail (byte loads: the tail of row r
// sits at r * (m + 4) + m, which need not be 4-byte aligned)
__device__ __forceinline__ float tail_scale(const int8_t* t) {
  const unsigned int bits = (unsigned int)(uint8_t)t[0] |
                            ((unsigned int)(uint8_t)t[1] << 8) |
                            ((unsigned int)(uint8_t)t[2] << 16) |
                            ((unsigned int)(uint8_t)t[3] << 24);
  return __uint_as_float(bits);
}

__global__ void q8_combine_kernel(const int8_t* __restrict__ wires,
                                  const float* __restrict__ partial,
                                  float* __restrict__ out, int64_t m) {
  const int64_t row = blockIdx.y;
  const int8_t* w = wires + row * (m + 4);
  const float scale = tail_scale(w + m);
  const float* p = partial + row * m;
  float* o = out + row * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    o[i] = __fadd_rn(p[i], __fmul_rn((float)w[i], scale));
}

__global__ void q8_unpack_kernel(const int8_t* __restrict__ wires,
                                 float* __restrict__ out, int64_t m) {
  const int64_t row = blockIdx.y;
  const int8_t* w = wires + row * (m + 4);
  const float scale = tail_scale(w + m);
  float* o = out + row * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    o[i] = __fmul_rn((float)w[i], scale);
}

// the combine's launch: the vector body where every pointer shares 16-byte
// alignment, and one block for each kThreads * kUnroll vectors (or
// kThreads scalars where there is no body), so the grid passes over the
// data once, in address order
template <typename T, int NCH>
void launch_combine(const T* recv, const T* partial, T* out, int64_t nch,
                    int64_t len, cudaStream_t s) {
  constexpr int64_t V = 16 / sizeof(T);
  constexpr int64_t kPer = (int64_t)kThreads * kUnroll;
  const auto mis = [](const void* p) {
    return (int64_t)((uintptr_t)p % 16) / (int64_t)sizeof(T);
  };
  const int64_t a = mis(partial);
  const bool shared = mis(out) == a && mis(recv) == a &&
                      (nch <= 1 || len % V == 0);
  const int64_t head = shared ? ((V - a) % V < len ? (V - a) % V : len) : len;
  const int64_t nvec = (len - head) / V;
  const int64_t scalars = len - nvec * V;
  int64_t blocks = (nvec + kPer - 1) / kPer;
  if ((scalars + kThreads - 1) / kThreads > blocks)
    blocks = (scalars + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  tree_combine_kernel<T, NCH><<<(unsigned int)blocks, kThreads, 0, s>>>(
      recv, partial, out, nch, len, head, nvec);
}

template <typename T>
void combine_n(const void* recv, const void* partial, void* out, int64_t nch,
               int64_t len, cudaStream_t s) {
  if (nch == 1)
    launch_combine<T, 1>((const T*)recv, (const T*)partial, (T*)out, nch,
                         len, s);
  else
    launch_combine<T, 0>((const T*)recv, (const T*)partial, (T*)out, nch,
                         len, s);
}

// the combine and unpack's (slab, row) grid: enough slabs per row that all rows together fill the
// card, never more slabs than a row has thread-sized pieces
inline dim3 grid_rows(int64_t rows, int64_t m) {
  int64_t per_row = (kMaxBlocks + rows - 1) / rows;
  const int64_t need = (m + kThreads - 1) / kThreads;
  if (per_row > need) per_row = need;
  if (per_row < 1) per_row = 1;
  return dim3((unsigned int)per_row, (unsigned int)rows, 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
int tree_combine(int dtype, const void* recv, const void* partial, void* out,
                 int64_t nch, int64_t len, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (len > 0) {
    if (dtype == 0) {
      combine_n<float>(recv, partial, out, nch, len, s);
    } else if (dtype == 1) {
      combine_n<__nv_bfloat16>(recv, partial, out, nch, len, s);
    } else if (dtype == 2) {
      combine_n<__half>(recv, partial, out, nch, len, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// x (rows, m) f32 -> wires (rows, m + 4) int8; amax: rows uint32 of scratch.
// Both passes: one block per kThreads * kUnroll vectors of a row.
int q8_pack_rows(const void* x, void* wires, void* amax, int64_t rows,
                 int64_t m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0) {
    constexpr int64_t kPer = (int64_t)kThreads * kUnroll;
    int64_t blocks = ((m + 3) / 4 + kPer - 1) / kPer;
    if (blocks < 1) blocks = 1;
    const dim3 g((unsigned int)blocks, (unsigned int)rows, 1);
    cudaMemsetAsync(amax, 0, (size_t)rows * sizeof(unsigned int), s);
    q8_absmax_kernel<<<g, kThreads, 0, s>>>((const float*)x,
                                            (unsigned int*)amax, m);
    q8_quantize_kernel<<<g, kThreads, 0, s>>>(
        (const float*)x, (const unsigned int*)amax, (int8_t*)wires, m);
  }
  return (int)cudaGetLastError();
}

// out (rows, m) f32 = partial + dequantize(wires (rows, m + 4))
int q8_combine_rows(const void* wires, const void* partial, void* out,
                    int64_t rows, int64_t m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0 && m > 0) {
    q8_combine_kernel<<<grid_rows(rows, m), kThreads, 0, s>>>(
        (const int8_t*)wires, (const float*)partial, (float*)out, m);
  }
  return (int)cudaGetLastError();
}

// out (rows, m) f32 = dequantize(wires (rows, m + 4))
int q8_unpack_rows(const void* wires, void* out, int64_t rows, int64_t m,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0 && m > 0) {
    q8_unpack_kernel<<<grid_rows(rows, m), kThreads, 0, s>>>(
        (const int8_t*)wires, (float*)out, m);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
