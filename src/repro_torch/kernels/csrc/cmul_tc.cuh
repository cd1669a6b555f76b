// cmul_tc.cuh — the machinery shared by quant_matmul.cu and
// bitserial_matmul.cu: a packed-weight float32 matmul on Hopper's tensor
// cores (sm_90a), in two TF32 passes, with K split across a thread-block
// cluster and the operands staged by asynchronous copies.
//
//   y[m, n] = scale[n] * (sum_p sum_k x[m, k] * B_p[k, n] - R[m])
//
// x (M, K) float32, packed (K / vpb, N) uint8 (vpb = 8 / BITS fields a byte,
// least significant first along K: core/quant.pack_planes), scale (1, N)
// float32 -> y (M, N) float32, row-major and contiguous. An operand policy
// `Op` (the thin part of each .cu file) says how a field u becomes the
// exact operand B_p: quant_matmul has one plane, the dequantized code;
// bitserial_matmul one plane per bit, c_p * bit_p(u). R is the row sum of x
// where Op::kRowSum is set (the 1-bit CMUL: 2 * (x . P_0) - rowsum(x)).
//
// Why two passes. wgmma's .tf32 operands keep 10 explicit mantissa bits, so
// one pass rounds x to about 4.9e-4 relative, and at (M, K, N) = (128, 512,
// 256) the result misses the float32 tolerance of 1e-4 (about 2e-4 of
// max|y|). B is exact in TF32 (|q| <= 128 needs 8 significant bits, a plane
// entry is 0 or a power of two), so only x is split: x_hi = rna_tf32(x),
// x_lo = rna_tf32(x - x_hi), and x_hi . B + x_lo . B leaves a residual of at
// most 2^-22 |x| per term. A numpy emulation at that shape gives 9.6e-8 to
// 2.2e-7 of max|y| for two passes against 3.9e-7 to 6.1e-7 for float32
// FMAs (tests/test_torch_cmul.py pins both cases). cvt.rna rounds to
// nearest; the tensor core would otherwise drop x's low bits by truncation.
//
// The design, one warpgroup (128 threads) a block:
// - a block owns a 64 x 32 output tile and one K range of it; a cluster of
//   S blocks (S in 1, 2, 4, 8, picked from the tile count and K so that the
//   grid fills the blocks the card holds at once) splits K. The partial
//   tiles meet through distributed shared memory: each rank sums, in rank
//   order, one slice of rows from all S ranks and scales and stores it. One
//   launch, no atomics (the result is bit-identical run to run), no
//   workspace.
// - x (64 x 32 floats) and the packed bytes (32 / vpb rows of 32 bytes) of
//   each 32-wide K chunk are staged by cp.async into a ring of kStages
//   slots, each completing on its own mbarrier, so the next chunks' loads
//   are in flight while the current chunk is unpacked and multiplied. The
//   packed bytes come from device memory once, at BITS / 8 bytes a weight.
// - the chunk's bytes are unpacked into B_p, K-major in shared memory in
//   wgmma's unswizzled core-matrix layout (8 rows of 16 bytes): vpb
//   consecutive fields of a byte are consecutive K entries, so each thread
//   writes 16-byte rows.
// - A comes from registers: each thread loads its fragment of x, splits it
//   into x_hi and x_lo, and issues wgmma.m64n32k8 against B_p for both, all
//   into one float32 accumulator: 2 * planes MMAs per 8-wide k-step.
// - that accumulator holds one chunk's sum only, and is added into a second
//   one by float32 FADDs after the chunk. The tensor cores do not round
//   their accumulation to nearest, so the error of one accumulator grows
//   with the MMAs chained into it: over all of K = 4096 (8192 chained MMAs
//   for 8-bit planes) it came close to the 1e-4 tolerance on the card. A
//   chunk chains 8 (quant_matmul) to 64 MMAs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cmul {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBM = 64;        // wgmma's M
constexpr int kBN = 32;        // wgmma's N here
constexpr int kBK = 32;        // K chunk: 4 k-steps of 8
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kMaxSplit = 8;   // the portable cluster size
constexpr int kMaxGridY = 65535;
constexpr int kXS = kBK + 4;   // staged x row in floats: 16 B aligned rows,
                               // conflict-free fragment loads
constexpr int kRS = kBN + 4;   // partial-tile row, floats
// B_p tile: element (n, k) at (n / 8) * kSBO + (k / 4) * kLBO + (n % 8) * 16
// + (k % 4) * 4 bytes: 8 x 16-byte core matrices, K-adjacent ones kLBO
// apart, N-adjacent ones kSBO apart (wgmma's K-major, no-swizzle layout)
constexpr int kLBO = 128;
constexpr int kSBO = (kBK / 4) * kLBO;
constexpr int kBTileBytes = kBN * kBK * 4;
constexpr int kXsBytes = kBM * kXS * 4;

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the mbarrier at `bar` counts one arrival when every cp.async this thread
// has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLBO >> 4) << 16) |
         (static_cast<uint64_t>(kSBO >> 4) << 32);
}

// d += a . B over one 8-wide k-step: A (64 x 8) from registers, B (8 x 32)
// from shared memory through its descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keeps the compiler from moving accesses to the accumulator across the
// asynchronous MMAs
__device__ __forceinline__ void fence_operand(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- the kernel ------------------------------------------------------------

template <int BITS>
__host__ __device__ constexpr int vpb() {
  return 8 / BITS;
}

template <class Op>
__host__ __device__ constexpr int pk_bytes() {  // a chunk's bytes, 16 B aligned
  return (kBK / vpb<Op::kBits>() * kBN + 15) / 16 * 16;
}

template <class Op>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (kXsBytes + pk_bytes<Op>()) + Op::kPlanes * kBTileBytes +
         kStages * 8;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
cmul_tc_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, float* __restrict__ y, int M,
               int K, int N, int vec_x, int vec_p) {
  constexpr int kBits = Op::kBits;
  constexpr int kVpb = vpb<kBits>();
  constexpr unsigned kMask = (1u << kBits) - 1u;
  constexpr int kPk = kBK / kVpb;         // packed rows a chunk
  constexpr int kG = kVpb > 4 ? kVpb : 4;  // K entries a thread unpacks
  constexpr int kUnits = kBN * kBK / kG;

  extern __shared__ __align__(128) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kStages][kBM][kXS]
  uint8_t* pk = smem + kStages * kXsBytes;     // [kStages][pk_bytes]
  uint8_t* bt = pk + kStages * pk_bytes<Op>(); // [kPlanes][B tile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(bt + Op::kPlanes * kBTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int q = tid % 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kp_rows = K / kVpb;
  const uint32_t rank = cluster_rank();
  const uint32_t split = cluster_size();
  const int nchunks = (K + kBK - 1) / kBK;
  const int per_rank = (nchunks + split - 1) / split;
  const int c0 = min(nchunks, static_cast<int>(rank) * per_rank);
  const int count = min(nchunks, c0 + per_rank) - c0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&bars[s]), kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // chunk c into ring slot s: every thread issues its copies, then arrives
  auto load = [&](int s, int c) {
    const int k0 = c * kBK;
    float* xd = xs + s * kBM * kXS;
    if (vec_x) {
      for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
        const int r = e / (kBK / 4), k = k0 + 4 * (e % (kBK / 4));
        const bool in = m0 + r < M && k < K;
        cp_async16(smem_addr(xd + r * kXS + (k - k0)),
                   in ? x + static_cast<size_t>(m0 + r) * K + k : x,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, k = k0 + e % kBK;
        const bool in = m0 + r < M && k < K;
        cp_async4(smem_addr(xd + r * kXS + (k - k0)),
                  in ? x + static_cast<size_t>(m0 + r) * K + k : x, in ? 4 : 0);
      }
    }
    if (vec_p) {  // otherwise the unpacking reads the bytes itself
      uint8_t* pd = pk + s * pk_bytes<Op>();
      for (int e = tid; e < kPk * kBN / 16; e += kThreads) {
        const int r = e / (kBN / 16), n = n0 + 16 * (e % (kBN / 16));
        const int row = c * kPk + r;
        const bool in = row < kp_rows && n < N;
        cp_async16(smem_addr(pd + r * kBN + (n - n0)),
                   in ? packed + static_cast<size_t>(row) * N + n : packed,
                   in ? 16 : 0);
      }
    }
    cp_async_arrive(smem_addr(&bars[s]));
  };

  for (int i = 0; i < kStages && i < count; ++i) load(i, c0 + i);

  float acc[16];  // the tensor cores' sum over one chunk
  float tot[16];  // the chunks' sums, added in float32
#pragma unroll
  for (int i = 0; i < 16; ++i) tot[i] = 0.f;
  float rs[2] = {0.f, 0.f};  // row sums of x, rows g and g + 8 (Op::kRowSum)

  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    const int c = c0 + i;
    mbar_wait(smem_addr(&bars[s]), (i / kStages) & 1);

    // unpack: thread unit (n, kG K entries) -> kG / 4 16-byte rows a plane
    const uint8_t* ps = pk + s * pk_bytes<Op>();
    for (int u = tid; u < kUnits; u += kThreads) {
      const int nl = u % kBN;
      const int kl = (u / kBN) * kG;
      unsigned f[kG];
#pragma unroll
      for (int j = 0; j < kG / kVpb; ++j) {
        const int r = kl / kVpb + j;
        unsigned byte;
        if (vec_p) {
          byte = ps[r * kBN + nl];
        } else {
          const int row = c * kPk + r, n = n0 + nl;
          const bool in = row < kp_rows && n < N;
          byte = in ? packed[static_cast<size_t>(row) * N + n] : 0u;
        }
#pragma unroll
        for (int v = 0; v < kVpb; ++v)
          f[j * kVpb + v] = (byte >> (v * kBits)) & kMask;
      }
      uint8_t* dst = bt + (nl / 8) * kSBO + (kl / 4) * kLBO + (nl % 8) * 16;
#pragma unroll
      for (int p = 0; p < Op::kPlanes; ++p)
#pragma unroll
        for (int t = 0; t < kG / 4; ++t)
          *reinterpret_cast<float4*>(dst + p * kBTileBytes + t * kLBO) =
              make_float4(
                  Op::value(f[4 * t], p), Op::value(f[4 * t + 1], p),
                  Op::value(f[4 * t + 2], p), Op::value(f[4 * t + 3], p));
    }

    // this thread's A fragments, split into TF32 high and low parts
    const float* xr = xs + s * kBM * kXS + (16 * warp + g) * kXS + q;
    uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float a[4] = {xr[8 * kk], xr[8 * kXS + 8 * kk], xr[8 * kk + 4],
                          xr[8 * kXS + 8 * kk + 4]};
      if constexpr (Op::kRowSum) {
        rs[0] += a[0] + a[2];
        rs[1] += a[1] + a[3];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[kk][j] = tf32_rna(a[j]);
        lo[kk][j] = tf32_rna(a[j] - __uint_as_float(hi[kk][j]));
      }
    }
    // B visible to the tensor cores' (async) proxy; slot s free again
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + kStages < count) load(s, c + kStages);

#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    fence_operand(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int p = 0; p < Op::kPlanes; ++p) {
        const uint64_t d =
            b_desc(smem_addr(bt + p * kBTileBytes + kk * 2 * kLBO));
        wgmma_tf32(acc, hi[kk], d);
        wgmma_tf32(acc, lo[kk], d);
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operand(acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) tot[j] += acc[j];
    __syncthreads();  // every warp's MMAs done before B is rewritten
  }

  if constexpr (Op::kRowSum) {  // lanes 4 g + q (q < 4) hold rows g, g + 8
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
    }
  }

  // partial tile into shared memory (ring slots are idle: every copy landed)
  float* red = xs;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = (i / 2) % 2;
    const int row = 16 * warp + g + 8 * h;
    const int col = 8 * (i / 4) + 2 * q + i % 2;
    red[row * kRS + col] = Op::kRowSum ? tot[i] - rs[h] : tot[i];
  }
  cluster_sync();

  // rank r sums rows [r * kBM / split, (r + 1) * kBM / split) over the ranks
  const int rows = kBM / split;
  const uint32_t base = smem_addr(red);
  for (int e = tid; e < rows * kBN; e += kThreads) {
    const int row = rank * rows + e / kBN;
    const int col = e % kBN;
    const int m = m0 + row, n = n0 + col;
    const uint32_t addr = base + (row * kRS + col) * 4;
    float v = 0.f;
    for (uint32_t j = 0; j < split; ++j) v += ld_cluster(addr, j);
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = v * scale[n];
  }
  cluster_sync();  // no block leaves while its tile is still being read
}

// ---- host side -------------------------------------------------------------

struct Plan {
  dim3 grid;
  int split;
  int smem;
  int per_sm;  // blocks of this kernel an SM holds at once
};

// The grid and the K split of one launch on the current card: S doubles
// while the grid stays within one wave of resident blocks (SMs x blocks an
// SM holds) and every rank keeps a K chunk. Sets the kernel's shared-memory
// limit, which the occupancy query and the launch need.
template <class Op>
cudaError_t plan(int M, int K, int N, Plan* pl) {
  pl->smem = smem_bytes<Op>();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cmul_tc_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               pl->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pl->per_sm, cmul_tc_kernel<Op>, kThreads, pl->smem);
  if (err != cudaSuccess) return err;
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int nchunks = (K + kBK - 1) / kBK;
  const long long wave = static_cast<long long>(sms) * pl->per_sm;
  int split = 1;
  while (split * 2 <= kMaxSplit && split * 2 <= nchunks &&
         static_cast<long long>(tiles_m) * tiles_n * split * 2 <= wave)
    split *= 2;
  pl->grid = dim3(tiles_n, tiles_m, split);
  pl->split = split;
  return cudaSuccess;
}

// Checks the shape, launches on `stream` and returns the CUDA error (0 on
// success): a launch the card refuses (shared memory, cluster) is returned,
// never replaced.
template <class Op>
int launch(const void* x, const void* packed, const void* scale, void* y,
           int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || K % vpb<Op::kBits>() || (M + kBM - 1) / kBM > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = plan<Op>(M, K, N, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = pl.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = pl.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_p =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, cmul_tc_kernel<Op>,
                           static_cast<const float*>(x),
                           static_cast<const uint8_t*>(packed),
                           static_cast<const float*>(scale),
                           static_cast<float*>(y), M, K, N, vec_x, vec_p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out = {grid.x, grid.y, grid.z, cluster size, dynamic shared memory bytes,
// blocks an SM holds}; returns the CUDA error (0 on success)
template <class Op>
int geometry(int M, int K, int N, int* out) {
  Plan pl;
  const cudaError_t err = plan<Op>(M, K, N, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.grid.x;
  out[1] = pl.grid.y;
  out[2] = pl.grid.z;
  out[3] = pl.split;
  out[4] = pl.smem;
  out[5] = pl.per_sm;
  return 0;
}

}  // namespace cmul
