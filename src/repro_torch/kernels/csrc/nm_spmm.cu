// nm_spmm — the SPE's balanced select-index sparse matmul, for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_r values[r, n] * x[m, (r / keep) * G + select[r, n]]
//
// x (M, K) float32, values (Kk, N) int8, select (Kk, N) uint8, scale (1, N)
// float32 -> y (M, N) float32, all row-major and contiguous, K == (Kk/keep)*G.
//
// Replaces repro/kernels/nm_spmm.py:nm_spmm_2d (the Pallas TPU kernel). That
// kernel walks K as a sequential grid axis, decompressing a weight tile into
// VMEM and accumulating one MXU dot per step. Blocks on this card run in no
// order, so K is a loop inside the block instead: on the VA model K <= 192
// and Kk <= 96, so one block holds its whole x row tile and its whole strip
// of compressed weights in shared memory.
//
// What bounds it on this card: bytes. At bucket 256 the 7 launches of one
// VA execute move about 83 MB (float32 im2col patches in, float32 out, int8 +
// uint8 weights) against about 0.63 GFLOP of sparse multiply-adds: about
// 25 us of HBM at 3.35 TB/s against 9.5 us of float32 FMA at 67 TFLOP/s
// (H100 SXM data sheet; chip_smoke.py measures the real times).
//
// What the design does about it: every x element is read from device memory
// once per 32-column strip (once in all on the VA model, where N <= 32 for
// the big-M layers and the strips of one row tile run side by side, so the
// re-reads of N = 48..96 come from L2), with 16-byte coalesced loads; the
// compressed weights, a few KB, are read once per block; y is written once,
// coalesced along n. The select is the SPE's "pick one of 16 registers": the
// 32 lanes of a warp own 32 output columns of the same row and gather from
// one 16-float window of that row in shared memory, which is free of bank
// conflicts. Each thread keeps 8 rows' sums in registers. Sums are float32
// in r order, and the scale is applied once at the end, as in the reference.
// The int8 codes are read, not the packed bit planes (the reference kernel
// path does the same). Tensor cores are not used: float32 inputs would need
// TF32, which misses the 1e-4 tolerance; that is for a later version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 32;                         // one lane per column
constexpr int kRowsPerThread = 8;                   // register tile
constexpr int kBlockM = kWarps * kRowsPerThread;    // 64 rows per block
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
nm_spmm_kernel(const float* __restrict__ x, const int8_t* __restrict__ values,
               const uint8_t* __restrict__ select,
               const float* __restrict__ scale, float* __restrict__ y, int M,
               int K, int N, int Kk, int G, int keep) {
  extern __shared__ float smem[];
  float* xs = smem;                                        // [kBlockM][K]
  float* ws = xs + kBlockM * K;                            // [Kk][kBlockN]
  int* ks = reinterpret_cast<int*>(ws + Kk * kBlockN);     // [Kk][kBlockN]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBlockN;
  const int m0 = blockIdx.y * kBlockM;
  const int rows = min(kBlockM, M - m0);

  // Stage the x row tile: rows * K contiguous floats. K is a multiple of
  // G = 16 in practice, so a 16-byte aligned tile copies as float4.
  const float* xg = x + static_cast<size_t>(m0) * K;
  const int total = rows * K;
  if ((reinterpret_cast<uintptr_t>(xg) & 15) == 0 && (total & 3) == 0) {
    const float4* src = reinterpret_cast<const float4*>(xg);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int i = tid; i < total / 4; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = tid; i < total; i += kThreads) xs[i] = xg[i];
  }
  for (int i = total + tid; i < kBlockM * K; i += kThreads) xs[i] = 0.f;

  // Stage this strip's weights as float values and dense K indices.
  for (int i = tid; i < Kk * kBlockN; i += kThreads) {
    const int r = i / kBlockN;
    const int n = n0 + i % kBlockN;
    float w = 0.f;
    int k = 0;
    if (n < N) {
      const size_t at = static_cast<size_t>(r) * N + n;
      w = static_cast<float>(values[at]);
      k = (r / keep) * G + select[at];
    }
    ws[i] = w;
    ks[i] = k;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xrow = xs + warp * K;  // rows warp, warp + 8, ...
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int r = 0; r < Kk; ++r) {
    const float w = ws[r * kBlockN + lane];
    const int k = ks[r * kBlockN + lane];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      acc[i] = fmaf(w, xrow[i * kWarps * K + k], acc[i]);
  }

  const int n = n0 + lane;
  if (n < N) {
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = warp + i * kWarps;
      if (m < rows) y[static_cast<size_t>(m0 + m) * N + n] = acc[i] * s;
    }
  }
}

}  // namespace

// Dynamic shared memory one launch needs; the wrapper checks it against the
// card's per-block limit before launching.
extern "C" size_t nm_spmm_smem_bytes(int K, int Kk) {
  return static_cast<size_t>(kBlockM) * K * sizeof(float) +
         static_cast<size_t>(Kk) * kBlockN * (sizeof(float) + sizeof(int));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nm_spmm_f32(const void* x, const void* values,
                           const void* select, const void* scale, void* y,
                           int M, int K, int N, int Kk, int G, int keep,
                           void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const int grid_y = (M + kBlockM - 1) / kBlockM;
  if (grid_y > kMaxGridY || K <= 0 || Kk <= 0 || keep <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nm_spmm_smem_bytes(K, Kk);
  cudaError_t err = cudaFuncSetAttribute(
      nm_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockN - 1) / kBlockN, grid_y);
  nm_spmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(values),
      static_cast<const uint8_t*>(select), static_cast<const float*>(scale),
      static_cast<float*>(y), M, K, N, Kk, G, keep);
  return static_cast<int>(cudaGetLastError());
}
