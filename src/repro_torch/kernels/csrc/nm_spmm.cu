// nm_spmm — the SPE's balanced select-index sparse matmul, for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_r values[r, n] * x[m, (r / keep) * G + select[r, n]]
//
// x (M, K) float32, values (Kk, N) int8, select (Kk, N) uint8, scale (1, N)
// float32 -> y (M, N) float32, all row-major and contiguous, K == (Kk/keep)*G.
//
// Replaces repro/kernels/nm_spmm.py:nm_spmm_2d (the Pallas TPU kernel). That
// kernel walks K as a sequential grid axis, decompressing a weight tile into
// VMEM and accumulating one MXU dot per step, so it takes any K that is a
// multiple of the group. Here each block decompresses its strip once and
// keeps it, or, where the strip does not fit in shared memory (the LMs'
// widths), streams it in K segments of whole groups (spe_tc.cuh holds the
// whole design; this file says only where x's rows lie).
//
// What bounds it on this card: bytes. At bucket 256 the 7 launches of one
// VA execute move about 83 MB (float32 im2col patches in, float32 out, int8 +
// uint8 weights): about 25 us of HBM at 3.35 TB/s, against 0.63 GFLOP of
// sparse multiply-adds (9.5 us of float32 FMA at 67 TFLOP/s) or two TF32
// passes over the dense K, 2.5 GFLOP, 5 us at 495 TFLOP/s (H100 SXM data
// sheet; chip_smoke.py measures the real times).
//
// What the design does about it: x is read from device memory once, 16
// bytes a copy (an output tile covers all N of a VA layer; at conv5 and
// conv6 narrower tiles fill the card, and their re-reads of x come from
// L2), through a ring of cp.async slots that keeps the next chunks' loads
// in flight while the tensor cores multiply; the compressed weights are
// read once a block; y is written once, in whole 32-byte sectors.

#include "spe_tc.cuh"

namespace {

// x itself: row m is x[m * K ...], K entries
struct DenseRows {
  static constexpr bool kSegments = true;  // a long strip streams
  const float* x;
  int M, K;
  __device__ spe::Rows row(int m) const {
    return {static_cast<long long>(m) * K, 0, m < M ? K : 0};
  }
};

}  // namespace

// The least dynamic shared memory a launch at (K, N) with group G takes:
// the whole strip's B tile at the widest width that fits, and the ring; or
// one segment's where no whole strip fits. Over the card's per-block limit
// only where not one segment of whole groups fits; the wrapper checks it
// before launching.
extern "C" size_t nm_spmm_smem_bytes(int K, int N, int G) {
  return spe::least_smem(K, N, G);
}

// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int nm_spmm_f32(const void* x, const void* values,
                           const void* select, const void* scale, void* y,
                           int M, int K, int N, int Kk, int G, int keep,
                           void* stream) {
  const DenseRows rows{static_cast<const float*>(x), M, K};
  const int vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return spe::launch(rows, values, select, scale, y, M, K, N, Kk, G, keep, vec,
                     static_cast<cudaStream_t>(stream));
}

// The launch's geometry on the current card, into out[8] (spe::geometry);
// returns the CUDA error (0 on success).
extern "C" int nm_spmm_geometry(int M, int K, int N, int G, int* out) {
  return spe::geometry<DenseRows>(M, K, N, G, out);
}
