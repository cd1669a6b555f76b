// sparse_conv1d — one VA layer fused: SAME-padded strided windows cut from
// the signal and the SPE's balanced select-index sparse matmul, for Hopper
// (sm_90a).
//
//   y[b, t, n] = scale[n] * sum_r values[r, n] * xpad[b, t * stride + tap, ch]
//
// where compressed row r of column n reads dense row d = (r / keep) * G +
// select[r, n], tap = d / C and ch = d % C, and xpad is x with XLA's SAME
// padding (pad_l zeros on the left). Dense rows d >= ks * C are the
// compiler's group padding: they contribute zero, and x is not read for them.
//
// x (B, T, C) float32, unpadded; values (Kk, N) int8; select (Kk, N) uint8;
// scale (1, N) float32 -> y (B, T_out, N) float32, all row-major and
// contiguous. T_out and pad_l come from the wrapper (core/spe.same_padding).
//
// Replaces repro/kernels/sparse_conv1d.py:sparse_conv1d_call (the Pallas TPU
// kernel). Its point is that no im2col patches are written to device memory:
// it cuts the windows inside VMEM. This kernel keeps that. A block takes one
// batch row, one tile of kBlockT output steps and a 32-column strip; it stages
// the tile's input span, (kBlockT - 1) * stride + ks rows of C floats, in
// shared memory once (zeros where the span runs past either end of x: the
// SAME padding is never materialised), and every output row reads its window
// from there. In the staged span the window of local output row m starts at
// m * stride * C, and (tap, ch) sits at offset tap * C + ch = d inside it, so
// the dense row index d is itself the offset: no division by C in the loop.
//
// What bounds it on this card: bytes and operations about equally. At
// bucket 256 the seven sparse VA layers read about 23 MB of activations and
// write about 23 MB against 0.63 GFLOP of sparse multiply-adds: about 14 us
// of HBM at 3.35 TB/s against 9.5 us of float32 FMA at 67 TFLOP/s (H100 SXM
// data sheet), and layer by layer the two are close, so which one bounds
// varies (chip_smoke.py reckons both per layer from its inputs and measures
// the kernel). The im2col path (core/compiler.execute: patches written, then
// nm_spmm) moves about 83 MB for the same work.
//
// What the design does about it: x is read from device memory once per
// 32-column strip (the strips of one tile run side by side, so for N > 32 the
// re-reads come from L2), coalesced; the compressed weights, a few KB, are
// read once per block and decoded into shared memory as a float weight and a
// dense offset (-1 for group padding); y is written once, coalesced along n.
// As in nm_spmm the 32 lanes of a warp own 32 output columns of one output
// row and gather from one 16-float group window of that row's span, free of
// bank conflicts; each thread keeps RPT rows' sums in registers, and RPT
// shrinks with T_out so that short layers (conv5, conv6) do not leave most
// warps idle. Sums are float32 FMAs in r order, and the scale comes last.
// Tensor cores are not used: float32 inputs would need TF32, which misses the
// 1e-4 tolerance of the float32 tests.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 32;  // one lane per output column
constexpr int kMaxGridY = 65535;
constexpr long long kMaxGridX = 2147483647LL;

// Rows per thread: the smallest of 1, 2, 4, 8 whose tile (kWarps * RPT
// output steps) covers T_out, else 8.
int rows_per_thread(int t_out) {
  int rpt = 1;
  while (rpt < 8 && kWarps * rpt < t_out) rpt *= 2;
  return rpt;
}

size_t smem_bytes(int rpt, int C, int Kk, int ks, int stride) {
  const size_t span = static_cast<size_t>(kWarps * rpt - 1) * stride + ks;
  return span * C * sizeof(float) +
         static_cast<size_t>(Kk) * kBlockN * (sizeof(float) + sizeof(int));
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
sparse_conv1d_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ values,
                     const uint8_t* __restrict__ select,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int T, int C, int N, int Kk, int ks, int stride,
                     int pad_l, int T_out, int tiles, int G, int keep) {
  constexpr int kBlockT = kWarps * RPT;
  extern __shared__ float smem[];
  const int span = (kBlockT - 1) * stride + ks;
  float* xs = smem;                                     // [span][C]
  float* ws = xs + span * C;                            // [Kk][kBlockN]
  int* ds = reinterpret_cast<int*>(ws + Kk * kBlockN);  // [Kk][kBlockN]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kBlockT;
  const int n0 = blockIdx.y * kBlockN;
  const int rows = min(kBlockT, T_out - t0);

  // Stage the input span: rows t0 * stride - pad_l ... of x[b]. Those rows
  // are contiguous in x, so span * C consecutive floats; any outside
  // [0, T * C) are the SAME padding and staged as zero.
  const float* xb = x + static_cast<size_t>(b) * T * C;
  const long long g0 = static_cast<long long>(t0 * stride - pad_l) * C;
  const long long g_end = static_cast<long long>(T) * C;
  for (int i = tid; i < span * C; i += kThreads) {
    const long long g = g0 + i;
    xs[i] = (g >= 0 && g < g_end) ? xb[g] : 0.f;
  }

  // Stage this strip's weights as a float value and a dense offset d; group
  // padding (d >= ks * C) and columns past N get offset -1 and are skipped.
  const int kc = ks * C;
  for (int i = tid; i < Kk * kBlockN; i += kThreads) {
    const int r = i / kBlockN;
    const int n = n0 + i % kBlockN;
    float w = 0.f;
    int d = -1;
    if (n < N) {
      const size_t at = static_cast<size_t>(r) * N + n;
      const int dd = (r / keep) * G + select[at];
      if (dd < kc) {
        w = static_cast<float>(values[at]);
        d = dd;
      }
    }
    ws[i] = w;
    ds[i] = d;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this thread's output rows are warp, warp + kWarps, ...; row m's window
  // starts at m * stride * C in the span
  const float* xw = xs + warp * stride * C;
  const int row_step = kWarps * stride * C;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int r = 0; r < Kk; ++r) {
    const int d = ds[r * kBlockN + lane];
    if (d < 0) continue;
    const float w = ws[r * kBlockN + lane];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      acc[i] = fmaf(w, xw[i * row_step + d], acc[i]);
  }

  const int n = n0 + lane;
  if (n < N) {
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = warp + i * kWarps;
      if (m < rows)
        y[(static_cast<size_t>(b) * T_out + t0 + m) * N + n] = acc[i] * s;
    }
  }
}

template <int RPT>
int launch(const void* x, const void* values, const void* select,
           const void* scale, void* y, int B, int T, int C, int N, int Kk,
           int ks, int stride, int pad_l, int T_out, int G, int keep,
           cudaStream_t stream) {
  constexpr int kBlockT = kWarps * RPT;
  const int tiles = (T_out + kBlockT - 1) / kBlockT;
  const long long grid_x = static_cast<long long>(B) * tiles;
  const int grid_y = (N + kBlockN - 1) / kBlockN;
  if (grid_x > kMaxGridX || grid_y > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(RPT, C, Kk, ks, stride);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_conv1d_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_x), grid_y);
  sparse_conv1d_kernel<RPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(values),
      static_cast<const uint8_t*>(select), static_cast<const float*>(scale),
      static_cast<float*>(y), T, C, N, Kk, ks, stride, pad_l, T_out, tiles, G,
      keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one launch needs; the wrapper checks it against the
// card's per-block limit before launching.
extern "C" size_t sparse_conv1d_smem_bytes(int T_out, int C, int Kk, int ks,
                                           int stride) {
  return smem_bytes(rows_per_thread(T_out), C, Kk, ks, stride);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sparse_conv1d_f32(const void* x, const void* values,
                                 const void* select, const void* scale,
                                 void* y, int B, int T, int C, int N, int Kk,
                                 int ks, int stride, int pad_l, int T_out,
                                 int G, int keep, void* stream) {
  if (B <= 0 || T_out <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (T <= 0 || C <= 0 || Kk <= 0 || ks <= 0 || stride <= 0 || G <= 0 ||
      keep <= 0 || pad_l < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_thread(T_out)) {
    case 1:
      return launch<1>(x, values, select, scale, y, B, T, C, N, Kk, ks,
                       stride, pad_l, T_out, G, keep, s);
    case 2:
      return launch<2>(x, values, select, scale, y, B, T, C, N, Kk, ks,
                       stride, pad_l, T_out, G, keep, s);
    case 4:
      return launch<4>(x, values, select, scale, y, B, T, C, N, Kk, ks,
                       stride, pad_l, T_out, G, keep, s);
    default:
      return launch<8>(x, values, select, scale, y, B, T, C, N, Kk, ks,
                       stride, pad_l, T_out, G, keep, s);
  }
}
