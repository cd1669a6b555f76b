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
// in no order: here the K range of a tile is split across a thread-block
// cluster and summed through distributed shared memory, and the scale is
// applied once after the whole K sum, as there.
//
// What bounds it on this card: at the benchmark shape (M, K, N) = (128, 512,
// 256) one launch moves 0.4 to 0.5 MB (x and y in float32, the packed
// weight at bits / 8 bytes a weight) against 2 * M * K * N = 34 MFLOP: 0.12
// to 0.16 us of HBM at 3.35 TB/s, 0.5 us of float32 FMA at 67 TFLOP/s, or
// 0.14 us for the two TF32 passes at 495 TFLOP/s (H100 SXM data sheet).
// Every one of these is far below what a launch costs, so at that shape the
// time is the launch, the latency of the first loads and the cluster
// reduction; the design below is about filling the card and keeping loads in
// flight. At (64, 4096, 4096) the two TF32 passes (8.7 us) bound it, ahead of
// the bytes (5.6 us at 8 bits).
//
// What the design does (cmul_tc.cuh holds all of it but the operand): the
// TF32 tensor cores (wgmma) in two passes, x_hi and x_lo, against the exact
// dequantized code; 64 x 32 output tiles whose K range is split across a
// cluster of up to 8 blocks (at the benchmark shape 16 tiles x 8 = 128
// blocks on the 132 SMs); x and the packed bytes staged by cp.async in a
// 4-slot mbarrier ring.
//
// Why two passes (max error / max|y| against float64, numpy emulation at
// (128, 512, 256), x standard normal):
//
//   bits                     8        4        2        1
//   one TF32 pass         2.0e-4   2.2e-4   2.2e-4   2.4e-4
//   two passes            2.2e-7   1.2e-7   9.6e-8   1.0e-7
//   float32 FMAs          6.1e-7   6.1e-7   3.9e-7   4.9e-7
//
// One pass misses the float32 tolerance of 1e-4; two land at float32's
// level. tests/test_torch_cmul.py pins both cases.

#include "cmul_tc.cuh"

namespace {

template <int BITS>
struct QuantOp {
  static constexpr int kBits = BITS;
  static constexpr int kPlanes = 1;
  static constexpr bool kRowSum = false;
  // the code of field u, exact in TF32 (|q| <= 128)
  __device__ static float value(unsigned u, int) {
    if (BITS == 1) return u ? 1.f : -1.f;
    constexpr unsigned kSign = 1u << (BITS - 1);
    return static_cast<float>(u >= kSign ? static_cast<int>(u) - (1 << BITS)
                                         : static_cast<int>(u));
  }
};

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int quant_matmul_f32(const void* x, const void* packed,
                                const void* scale, void* y, int M, int K,
                                int N, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return cmul::launch<QuantOp<8>>(x, packed, scale, y, M, K, N, s);
    case 4:
      return cmul::launch<QuantOp<4>>(x, packed, scale, y, M, K, N, s);
    case 2:
      return cmul::launch<QuantOp<2>>(x, packed, scale, y, M, K, N, s);
    case 1:
      return cmul::launch<QuantOp<1>>(x, packed, scale, y, M, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch's geometry on the current card, into out[6] (cmul::geometry);
// returns the CUDA error (0 on success).
extern "C" int quant_matmul_geometry(int M, int K, int N, int bits,
                                     int* out) {
  switch (bits) {
    case 8:
      return cmul::geometry<QuantOp<8>>(M, K, N, out);
    case 4:
      return cmul::geometry<QuantOp<4>>(M, K, N, out);
    case 2:
      return cmul::geometry<QuantOp<2>>(M, K, N, out);
    case 1:
      return cmul::geometry<QuantOp<1>>(M, K, N, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
