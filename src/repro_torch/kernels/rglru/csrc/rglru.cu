// Hopper (sm_90a) kernel for the RG-LRU gated linear recurrence
//   h_t = a_t * h_{t-1} + b_t
// over time, elementwise over the width.  Plain C entry point, bound with
// ctypes by ../kernel.py; it returns cudaGetLastError().
//
// Replaces (reference package, Pallas on TPU):
//   rglru_scan <- repro/kernels/rglru/kernel.py::rglru_scan
//
// What bounds it on an H100: one multiply and one add per element against
// 12 bytes moved (a and b read, h written, all f32), so the bound is the
// bytes over the 3.35 TB/s of HBM3: 1.007 GB, 0.30 ms, for one
// recurrentgemma-2b prefill layer of (8, 4096, 2560).  The TPU kernel
// walks time in chunks of a VMEM block in grid order, carrying h in
// scratch; here blocks run in parallel and cannot carry anything, so the
// time loop is inside the thread.  One thread owns one (batch, lane) pair
// and keeps h in a register; neighbouring threads hold neighbouring lanes,
// so every step's loads and store coalesce into 128-byte runs.  a and b do
// not depend on h, so each thread loads kAhead steps of both before it
// runs them: those loads are in flight together and hide the latency of
// device memory.  At the path's shape there are only B*W = 20,480 lanes
// (320 blocks of 64 threads, a few warps an SM), so this is the simple
// design; a chunked two-pass scan over time, which spreads T over more
// threads, is later work.
//
// Numerics: h = a*h + b is computed as an explicitly rounded multiply then
// add (__fmul_rn, __fadd_rn, no FMA contraction), the plain version's two
// roundings, so kernel and plain version agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAhead = 32;   // steps of a and b loaded before they are used

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int64_t T, int64_t W) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t row = blockIdx.y;
  const int64_t base = row * T * W + w;
  float hv = h0 != nullptr ? h0[row * W + w] : 0.0f;
  for (int64_t t0 = 0; t0 < T; t0 += kAhead) {
    const int64_t n = T - t0;
    float av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < n) {
        av[i] = a[base + (t0 + i) * W];
        bv[i] = b[base + (t0 + i) * W];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < n) {
        hv = __fadd_rn(__fmul_rn(av[i], hv), bv[i]);
        h[base + (t0 + i) * W] = hv;
      }
    }
  }
  h_last[row * W + w] = hv;
}

}  // namespace

extern "C" {

// a, b, h: (B, T, W) f32; h0: (B, W) f32 or null (zeros); h_last: (B, W)
int rglru_scan(const void* a, const void* b, const void* h0, void* h,
               void* h_last, int64_t B, int64_t T, int64_t W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 0 && W > 0) {
    const dim3 grid((unsigned int)((W + kThreads - 1) / kThreads),
                    (unsigned int)B, 1);
    rglru_scan_kernel<<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (const float*)h0, (float*)h,
        (float*)h_last, T, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
