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
// is reused across calls.  The design therefore only tries to keep every
// SM streaming: one grid-stride loop per kernel, coalesced (neighbouring
// threads on neighbouring addresses), and for the row kernels a 2-D grid
// of (slab, row) so that 16 rows still fill 132 SMs.  The pack needs the
// row's absmax before it can quantize, which on a TPU is one VMEM block;
// here blocks cannot see each other, so it takes two launches: an absmax
// pass (per-block max, then atomicMax on the float's bits, which orders
// like the value for non-negative floats) and a quantize pass.  Fusing the
// two, and 16-byte vector loads and stores (rows of m+4 bytes are not
// 16-byte aligned, so the simple version stores bytes), are later work.
//
// Numerics: the wire must be byte-identical to the plain version, so every
// step is an explicitly rounded intrinsic (no FMA contraction, no fast
// math): scale = absmax * (1/127) + 1e-30, lane = rint(x * (1 / scale)),
// rint rounding half to even like jnp.round / torch.round.  Do not build
// with --use_fast_math.
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

// out[i] = partial[i] + sum_c recv[c, i], accumulated in f32 (the children
// are summed first, then added to the partial, as the plain version does)
template <typename T>
__global__ void tree_combine_kernel(const T* __restrict__ recv,
                                    const T* __restrict__ partial,
                                    T* __restrict__ out, int64_t nch,
                                    int64_t len) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += stride) {
    float s = 0.0f;
    for (int64_t c = 0; c < nch; ++c) s = __fadd_rn(s, to_f32(recv[c * len + i]));
    out[i] = from_f32<T>(__fadd_rn(to_f32(partial[i]), s));
  }
}

// per-row max|x| into amax[row] (as float bits; amax zeroed by the caller)
__global__ void q8_absmax_kernel(const float* __restrict__ x,
                                 unsigned int* __restrict__ amax, int64_t m) {
  const int64_t row = blockIdx.y;
  const float* xr = x + row * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float v = 0.0f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    v = fmaxf(v, fabsf(xr[i]));
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) atomicMax(amax + row, __float_as_uint(v));
  }
}

// lanes = rint(x * (1 / scale)) as int8; block (0, row) writes the tail
__global__ void q8_quantize_kernel(const float* __restrict__ x,
                                   const unsigned int* __restrict__ amax,
                                   int8_t* __restrict__ out, int64_t m) {
  const int64_t row = blockIdx.y;
  const float scale =
      __fadd_rn(__fmul_rn(__uint_as_float(amax[row]), kInv127), 1e-30f);
  const float inv = __fdiv_rn(1.0f, scale);
  const float* xr = x + row * m;
  int8_t* o = out + row * (m + 4);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    o[i] = (int8_t)(int)rintf(__fmul_rn(xr[i], inv));
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    const unsigned int bits = __float_as_uint(scale);
    o[m + threadIdx.x] = (int8_t)((bits >> (8 * threadIdx.x)) & 0xffu);
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

inline unsigned int blocks_1d(int64_t len) {
  int64_t b = (len + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (unsigned int)(b < 1 ? 1 : b);
}

// (slab, row) grid: enough slabs per row that all rows together fill the
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
    const unsigned int b = blocks_1d(len);
    if (dtype == 0) {
      tree_combine_kernel<float><<<b, kThreads, 0, s>>>(
          (const float*)recv, (const float*)partial, (float*)out, nch, len);
    } else if (dtype == 1) {
      tree_combine_kernel<__nv_bfloat16><<<b, kThreads, 0, s>>>(
          (const __nv_bfloat16*)recv, (const __nv_bfloat16*)partial,
          (__nv_bfloat16*)out, nch, len);
    } else if (dtype == 2) {
      tree_combine_kernel<__half><<<b, kThreads, 0, s>>>(
          (const __half*)recv, (const __half*)partial, (__half*)out, nch, len);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// x (rows, m) f32 -> wires (rows, m + 4) int8; amax: rows uint32 of scratch
int q8_pack_rows(const void* x, void* wires, void* amax, int64_t rows,
                 int64_t m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows > 0) {
    cudaMemsetAsync(amax, 0, (size_t)rows * sizeof(unsigned int), s);
    const dim3 g = grid_rows(rows, m);
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
