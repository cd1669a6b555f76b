// bitserial_matmul — the CMUL's bit-plane matmul, for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_b c_b * S_b[m, n],
//   S_b[m, n] = sum_k x[m, k] * bit_b(u[k, n])
//
// where u[k, n] is the `bits`-bit two's-complement field of weight (k, n),
// unpacked from `packed`: each byte holds vpb = 8 / bits consecutive K
// entries, least significant first (core/quant.pack_planes). Plane b has the
// coefficient c_b = 2^b, the sign plane b = bits - 1 has c_b = -2^(bits-1).
// At 1 bit the single plane encodes {0, 1} -> {-1, +1}, so
// y = scale * (2 * S_0 - sum_k x[m, k]).
//
// x (M, K) float32, packed (K / vpb, N) uint8, scale (1, N) float32 ->
// y (M, N) float32, all row-major and contiguous; bits in {8, 4, 2, 1}.
//
// Replaces repro/kernels/bitserial.py:bitserial_matmul_2d (the Pallas TPU
// kernel). That kernel walks K as a sequential grid axis; per K tile it
// unpacks the planes into VMEM, runs one MXU dot per {0, 1} plane, weights
// it by its coefficient into the output block, and scales after the last K
// tile. Blocks on this card run in no order, so K is a loop inside the block
// instead. The plane decomposition is kept, not folded into a
// dequantize-then-multiply (that is quant_matmul): every plane has its own
// float32 sum over the whole K, held in registers, and the sums are combined
// with their coefficients, then scaled, once at the end.
//
// What bounds it on this card: at the benchmark shape (M, K, N) = (128, 512,
// 256) the function moves about 0.5 MB (x and y in float32, the packed
// weight at bits / 8 bytes a weight) against 2 * M * K * N = 67 MFLOP of
// work: 0.15 us of HBM at 3.35 TB/s against 0.5 us of float32 FMA at 67
// TFLOP/s (H100 SXM data sheet), so operations bound it, as they bound
// quant_matmul at the same shape. The plane loop does `bits` times that FMA
// work (one FMA per plane per weight, as the CMUL does one 1-bit product per
// segment), and at this size launch latency dominates either.
//
// What the design does: a block computes a 32 x 32 output tile with 256
// threads, each owning a 2 x 2 register tile of outputs and, for each, one
// float32 sum per plane (at 8 bits 32 sums a thread); the 1-bit kernel also
// keeps the row sums of x. Per 32-wide K chunk it stages x (32 x 32 floats,
// coalesced along K, rows padded by one float against bank conflicts) and the
// chunk's packed bytes as they are (32 / vpb rows of 32 bytes) in shared
// memory. The inner loop reads a byte once per thread and column, takes each
// field's bits in registers, and adds x into the plane sums with float32 FMAs
// (x * 1 or x * 0, exact, so no TF32 and no rounding beyond the sums').

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 32;
constexpr int kBN = 32;
constexpr int kBK = 32;  // a multiple of every vpb (1, 2, 4, 8)
constexpr int kTM = kBM / 16;
constexpr int kTN = kBN / 16;
constexpr int kMaxGridY = 65535;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
bitserial_matmul_kernel(const float* __restrict__ x,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        float* __restrict__ y, int M, int K, int N) {
  constexpr int kVpb = 8 / BITS;
  constexpr int kPk = kBK / kVpb;  // packed rows per K chunk
  __shared__ float xs[kBM][kBK + 1];
  __shared__ uint8_t ps[kPk][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kp_rows = K / kVpb;

  float acc[kTM][kTN][BITS];  // one sum per output and plane
  float rowsum[kTM];          // sum_k x[m, k], read only at 1 bit
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    rowsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
#pragma unroll
      for (int b = 0; b < BITS; ++b) acc[i][j][b] = 0.f;
  }

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
      ps[p][c] = (prow < kp_rows && n < N)
                     ? packed[static_cast<size_t>(prow) * N + n]
                     : uint8_t{0};
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPk; ++p) {
      unsigned word[kTN];
#pragma unroll
      for (int j = 0; j < kTN; ++j) word[j] = ps[p][tx + 16 * j];
#pragma unroll
      for (int v = 0; v < kVpb; ++v) {
        const int k = p * kVpb + v;
        float a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          a[i] = xs[ty + 16 * i][k];
          if (BITS == 1) rowsum[i] += a[i];
        }
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
#pragma unroll
          for (int b = 0; b < BITS; ++b) {
            // 1.0f or 0.0f from the bit's value, without a conversion
            const float bit = __uint_as_float(
                ((word[j] >> (v * BITS + b)) & 1u) * 0x3f800000u);
#pragma unroll
            for (int i = 0; i < kTM; ++i)
              acc[i][j][b] = fmaf(a[i], bit, acc[i][j][b]);
          }
        }
      }
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
      if (m >= M) continue;
      float out;
      if (BITS == 1) {
        out = 2.f * acc[i][j][0] - rowsum[i];
      } else {
        // shift-accumulate in plane order, as the plain version does
        out = acc[i][j][0];
#pragma unroll
        for (int b = 1; b < BITS; ++b) {
          const float c = b == BITS - 1 ? -static_cast<float>(1 << b)
                                        : static_cast<float>(1 << b);
          out += acc[i][j][b] * c;
        }
      }
      y[static_cast<size_t>(m) * N + n] = out * s;
    }
  }
}

template <int BITS>
int launch(const void* x, const void* packed, const void* scale, void* y,
           int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  bitserial_matmul_kernel<BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bitserial_matmul_f32(const void* x, const void* packed,
                                    const void* scale, void* y, int M, int K,
                                    int N, int bits, void* stream) {
  if (bits != 8 && bits != 4 && bits != 2 && bits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || K % (8 / bits) || (M + kBM - 1) / kBM > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch<8>(x, packed, scale, y, M, K, N, s);
    case 4:
      return launch<4>(x, packed, scale, y, M, K, N, s);
    case 2:
      return launch<2>(x, packed, scale, y, M, K, N, s);
    case 1:
      return launch<1>(x, packed, scale, y, M, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
