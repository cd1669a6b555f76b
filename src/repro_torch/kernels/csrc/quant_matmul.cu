// quant_matmul — packed sub-byte dequant matmul, for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_k x[m, k] * q[k, n]
//
// where q is unpacked from `packed`: each byte holds vpb = 8 / bits
// consecutive K entries, least significant first, as two's-complement
// `bits`-bit fields (core/quant.pack_planes); a field u sign-extends to
// u - 2^bits when u >= 2^(bits-1), and at 1 bit decodes {0, 1} -> {-1, +1}.
//
// x (M, K) float32, packed (K / vpb, N) uint8, scale (1, N) float32 ->
// y (M, N) float32, all row-major and contiguous; bits in {8, 4, 2, 1}.
//
// Replaces repro/kernels/quant_matmul.py:quant_matmul_2d (the Pallas TPU
// kernel). That kernel walks K as a sequential grid axis, unpacking one
// (bk / vpb, bn) tile into VMEM per step and accumulating one MXU dot into
// its output block, then scaling at the last step. Blocks on this card run
// in no order, so K is a loop inside the block instead, and the scale is
// applied once after the whole K sum, as there.
//
// What bounds it on this card: at the benchmark shape (M, K, N) = (128, 512,
// 256) one launch moves about 0.5 MB (x and y in float32, the packed weight
// at bits / 8 bytes a weight) against 34 MFLOP: 0.16 us of HBM at 3.35 TB/s
// against 0.5 us of float32 FMA at 67 TFLOP/s (H100 SXM data sheet).
// Operations bound it on paper, but both are well under the few microseconds
// a launch costs, so launch latency and the tail of a 32-block grid dominate
// at that shape (chip_smoke.py measures it).
//
// What the design does: a block computes a 32 x 32 output tile with 256
// threads, each holding a 2 x 2 register tile of float32 sums; small tiles
// give the benchmark shape 32 blocks rather than a handful. Per 32-wide K
// chunk it stages x (32 x 32 floats, coalesced along K, rows padded by one
// float against bank conflicts) and the packed bytes of the chunk, each byte
// read once from device memory, unpacked in registers into vpb sign-extended
// weights and stored as floats (32 x 32) in shared memory; then 32 rank-1
// updates of float32 FMAs. The packed weight is thus read at bits / 8 bytes a
// weight, the point of the format. Tensor cores are not used: float32 x would
// need TF32, which misses the 1e-4 tolerance of the float32 tests; the weights
// (|q| <= 127) are exact in float32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 32;
constexpr int kBN = 32;
constexpr int kBK = 32;  // a multiple of every vpb (8, 2, 4, 1 -> 1..8)
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;
constexpr int kMaxGridY = 65535;

template <int BITS>
__device__ __forceinline__ float decode(unsigned u) {
  if (BITS == 1) return u ? 1.f : -1.f;
  constexpr unsigned kSign = 1u << (BITS - 1);
  const int v = u >= kSign ? static_cast<int>(u) - (1 << BITS)
                           : static_cast<int>(u);
  return static_cast<float>(v);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale, float* __restrict__ y,
                    int M, int K, int N) {
  constexpr int kVpb = 8 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  constexpr int kPk = kBK / kVpb;  // packed rows per K chunk
  __shared__ float xs[kBM][kBK + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kp_rows = K / kVpb;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int m = m0 + r;
      const int k = k0 + c;
      xs[r][c] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
    }
    for (int i = tid; i < kPk * kBN; i += kThreads) {
      const int p = i / kBN;
      const int c = i % kBN;
      const int prow = k0 / kVpb + p;
      const int n = n0 + c;
      const bool in = prow < kp_rows && n < N;
      const unsigned u = in ? packed[static_cast<size_t>(prow) * N + n] : 0u;
#pragma unroll
      for (int j = 0; j < kVpb; ++j)
        ws[p * kVpb + j][c] = in ? decode<BITS>((u >> (j * BITS)) & kMask) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM];
      float b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) y[static_cast<size_t>(m) * N + n] = acc[i][j] * s;
    }
  }
}

template <int BITS>
int launch(const void* x, const void* packed, const void* scale, void* y,
           int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_matmul_kernel<BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int quant_matmul_f32(const void* x, const void* packed,
                                const void* scale, void* y, int M, int K,
                                int N, int bits, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || (M + kBM - 1) / kBM > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<8>(x, packed, scale, y, M, K, N, s);
    case 4:
      return K % 2 ? static_cast<int>(cudaErrorInvalidValue)
                   : launch<4>(x, packed, scale, y, M, K, N, s);
    case 2:
      return K % 4 ? static_cast<int>(cudaErrorInvalidValue)
                   : launch<2>(x, packed, scale, y, M, K, N, s);
    case 1:
      return K % 8 ? static_cast<int>(cudaErrorInvalidValue)
                   : launch<1>(x, packed, scale, y, M, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
