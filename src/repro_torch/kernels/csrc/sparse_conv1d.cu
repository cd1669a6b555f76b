// sparse_conv1d — one VA layer fused: SAME-padded strided windows cut from
// the signal and the SPE's balanced select-index sparse matmul, for Hopper
// (sm_90a).
//
//   y[b, t, n] = scale[n] * sum_r values[r, n] * xpad[b, t * stride + tap, ch]
//
// where compressed row r of column n reads dense row d = (r / keep) * G +
// select[r, n], tap = d / C and ch = d % C, and xpad is x with XLA's SAME
// padding (pad_l zeros on the left). Dense rows d >= ks * C are the
// compiler's group padding: they meet zeros.
//
// x (B, T, C) float32, unpadded; values (Kk, N) int8; select (Kk, N) uint8;
// scale (1, N) float32 -> y (B, T_out, N) float32, all row-major and
// contiguous. T_out and pad_l come from the wrapper (core/spe.same_padding).
//
// Replaces repro/kernels/sparse_conv1d.py:sparse_conv1d_call (the Pallas TPU
// kernel). Its point is that no im2col patches are written to device memory.
// This kernel keeps that: it is nm_spmm (spe_tc.cuh) on the patch matrix of
// the layer, (B * T_out, K), whose row m = b * T_out + t is never written
// anywhere. Its window, dense entries d = tap * C + ch, is one contiguous
// run of the signal, x[b] from (t * stride - pad_l) * C on, so the copies
// that stage a chunk of row m read it from there, and zero-fill what falls
// before 0 or after T * C (the SAME padding) or at d >= ks * C (the group
// padding: finite zeros, so 0 * NaN cannot arise). A 64-row tile may span
// several batch rows (T_out = 16 at conv6); each row finds its own.
//
// What bounds it on this card: bytes. At bucket 256 the seven sparse VA
// layers read about 23 MB of activations and write about 23 MB: about 14 us
// of HBM at 3.35 TB/s, against two TF32 passes over the dense K (5 us at 495
// TFLOP/s; H100 SXM data sheet). The im2col path (core/compiler.execute:
// patches written, then nm_spmm) moves about 83 MB for the same work. The
// windows overlap (ks / stride times at each signal row), so the copies
// read each row that often, from L2 after the first.
//
// Staged values, B tile, chunk order and plan are nm_spmm's for the same
// (B * T_out, K, N), so the result is bit-identical to im2col -> pad ->
// nm_spmm. Like the TPU kernel, which holds the whole (Kk, bn) strip and the
// whole signal in VMEM, it takes only a strip that fits whole in a block's
// shared memory: nm_spmm's K segments are not offered here.

#include "spe_tc.cuh"

namespace {

// the window of output step m = b * T_out + t, read from x[b]
struct WindowRows {
  static constexpr bool kSegments = false;  // the whole strip, as the TPU's
  const float* x;
  int M, T, C, T_out, stride, pad_l, kc;  // kc = ksize * C
  __device__ spe::Rows row(int m) const {
    if (m >= M) return {0, 0, 0};
    const int b = m / T_out, t = m % T_out;
    const long long s = static_cast<long long>(t * stride - pad_l) * C;
    const long long tc = static_cast<long long>(T) * C;
    const long long hi = tc - s < kc ? tc - s : kc;
    return {static_cast<long long>(b) * tc + s, s < 0 ? static_cast<int>(-s) : 0,
            static_cast<int>(hi)};
  }
};

}  // namespace

// Dynamic shared memory of a launch with dense K `k_dense` and N columns
// (nm_spmm's at the same K and N with the whole strip); over the card's
// per-block limit where no tile width fits; the wrapper checks it before
// launching.
extern "C" size_t sparse_conv1d_smem_bytes(int k_dense, int N) {
  return spe::fit_smem(k_dense, N);
}

// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int sparse_conv1d_f32(const void* x, const void* values,
                                 const void* select, const void* scale,
                                 void* y, int B, int T, int C, int N, int Kk,
                                 int ks, int stride, int pad_l, int T_out,
                                 int G, int keep, void* stream) {
  if (B <= 0 || T_out <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (T <= 0 || C <= 0 || Kk <= 0 || ks <= 0 || stride <= 0 || G <= 0 ||
      keep <= 0 || pad_l < 0 || Kk % keep)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(B) * T_out;
  const int k_dense = (Kk / keep) * G;
  if (m > 2147483647LL || k_dense < ks * C ||
      spe::fit_smem(k_dense, N) > static_cast<size_t>(spe::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const WindowRows rows{static_cast<const float*>(x), static_cast<int>(m), T,
                        C, T_out, stride, pad_l, ks * C};
  const int vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return spe::launch(rows, values, select, scale, y, static_cast<int>(m),
                     k_dense, N, Kk, G, keep, vec,
                     static_cast<cudaStream_t>(stream));
}

// The launch's geometry on the current card for B * T_out output steps,
// into out[8] (spe::geometry; the whole strip, one segment); returns the
// CUDA error (0 on success).
extern "C" int sparse_conv1d_geometry(int M, int K, int N, int* out) {
  if (spe::fit_smem(K, N) > static_cast<size_t>(spe::kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  return spe::geometry<WindowRows>(M, K, N, spe::kBK, out);
}
