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
// unpacks the planes into VMEM and runs `acc += coeff * dot(x, plane)` for
// each {0, 1} plane, then scales after the last K tile. Here the coefficient
// is folded into the exact operand: plane b's B tile holds c_b * P_b
// (entries 0 or c_b, exact in TF32), and every plane's MMAs go into one
// float32 accumulator. The planes are not folded back into one dequantized
// weight (that is quant_matmul): each plane is its own operand, 2 * bits
// MMAs per 8-wide k-step against quant_matmul's 2. At 1 bit the plane is
// 2 * P_0 and the row sum of x, kept in float32 from the same staged x, is
// subtracted, as the TPU kernel does.
//
// What bounds it on this card: the function is quant_matmul's, so its bound
// is the same (at (128, 512, 256): 0.12 to 0.16 us of HBM, 0.14 us for two
// TF32 passes of 2 * M * K * N, 0.5 us of float32 FMA; H100 SXM data
// sheet), and the plane decomposition multiplies the tensor-core work by
// `bits`: at 8 bits 16 MMAs per k-step, 1.1 us at 495 TFLOP/s at that shape,
// still under a launch's cost. At (64, 4096, 4096) and 8 bits the planes'
// MMAs (70 us at the TF32 peak) bound it.
//
// What the design does (cmul_tc.cuh holds all of it but the operand): the
// TF32 tensor cores (wgmma) in two passes, x_hi and x_lo, against each exact
// plane; 64 x 32 output tiles whose K range is split across a cluster of up
// to 8 blocks (at the benchmark shape 16 tiles x 8 = 128 blocks on the 132
// SMs); x and the packed bytes staged by cp.async in a 4-slot mbarrier
// ring. A byte is read from device memory once and unpacked
// into every plane in registers.
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
struct PlaneOp {
  static constexpr int kBits = BITS;
  static constexpr int kPlanes = BITS;
  static constexpr bool kRowSum = BITS == 1;
  // plane p's entry for field u: c_p * bit_p(u); at 1 bit c_0 = 2
  __device__ static float value(unsigned u, int p) {
    const float c = BITS == 1 ? 2.f
                    : p == BITS - 1 ? -static_cast<float>(1 << p)
                                    : static_cast<float>(1 << p);
    return (u >> p) & 1u ? c : 0.f;
  }
};

}  // namespace

// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int bitserial_matmul_f32(const void* x, const void* packed,
                                    const void* scale, void* y, int M, int K,
                                    int N, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return cmul::launch<PlaneOp<8>>(x, packed, scale, y, M, K, N, s);
    case 4:
      return cmul::launch<PlaneOp<4>>(x, packed, scale, y, M, K, N, s);
    case 2:
      return cmul::launch<PlaneOp<2>>(x, packed, scale, y, M, K, N, s);
    case 1:
      return cmul::launch<PlaneOp<1>>(x, packed, scale, y, M, K, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch's geometry on the current card, into out[6] (cmul::geometry);
// returns the CUDA error (0 on success).
extern "C" int bitserial_matmul_geometry(int M, int K, int N, int bits,
                                         int* out) {
  switch (bits) {
    case 8:
      return cmul::geometry<PlaneOp<8>>(M, K, N, out);
    case 4:
      return cmul::geometry<PlaneOp<4>>(M, K, N, out);
    case 2:
      return cmul::geometry<PlaneOp<2>>(M, K, N, out);
    case 1:
      return cmul::geometry<PlaneOp<1>>(M, K, N, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
