// spe_tc.cuh — the machinery shared by nm_spmm.cu and sparse_conv1d.cu: the
// SPE's balanced select-index sparse matmul on Hopper's tensor cores
// (sm_90a), weight-stationary, in two TF32 passes.
//
//   y[m, n] = scale[n] * sum_r values[r, n] * A[m, (r / keep) * G + select[r, n]]
//
// values (Kk, N) int8, select (Kk, N) uint8, scale (1, N) float32 -> y (M, N)
// float32, row-major and contiguous; K = (Kk / keep) * G is the dense K. An
// operand policy `X` (the thin part of each .cu file) says where row m of A
// lies in device memory: nm_spmm's A is x itself, sparse_conv1d's the
// SAME-padded window of one output step, read straight from the signal.
//
// It takes cmul_tc.cuh's building blocks as they are (the cp.async copies
// with zero-fill, the mbarriers, the cvt.rna split, the B descriptor, the
// m64n32k8 wgmma and the fence on the accumulator) and adds the wgmma widths
// the SPE's N needs. The reasons for two passes and for a second
// accumulator are cmul_tc.cuh's: the int8 code is exact in TF32, so only A is
// split, A_hi = rna(A) and A_lo = rna(A - A_hi), into one float32 sum a
// 32-wide K chunk, and the chunks' sums are added by float32 FADDs.
//
// The design, one warpgroup (128 threads) a block:
// - weight-stationary, as the chip's SPE is: a block decodes its (Kk, BN)
//   strip of compressed weights once into a dense K x BN float tile in shared
//   memory (zero where no compressed row selects an entry), in wgmma's
//   K-major core-matrix layout, 32-wide K chunk after chunk, each chunk laid
//   out as cmul_tc.cuh's B tile, so its descriptor serves unchanged. The
//   scale is applied once, in float32, after the whole K sum.
// - where the whole strip does not fit in shared memory at any width (the
//   LMs' wide K: qwen3-8b's down projection has K = 12 288; the TPU kernel
//   walks K on its grid and VMEM holds megabytes), the strip streams in K
//   segments, each a whole number of groups and of 32-wide chunks: the block
//   decodes one segment into the B tile, runs that segment's chunks for its
//   M tile, then decodes the next. The float32 sums stay in registers across
//   segments and the scale is applied once, after the last, so the chain of
//   MMAs and FADDs is the one a whole strip would give. A segment fills at
//   most kSegSmem with the ring, so that two blocks share an SM; the
//   segmented kernel is a separate instantiation (kSeg), at BN 8 and 24
//   only. A block that walks several M tiles decodes every segment again
//   for each (none does at M <= 64). Where the strip fits (every VA layer),
//   the plan and the kernel's code are the whole strip's.
// - an output tile covers all N columns where it can: BN is one of kWidths
//   (the VA model's N is 16 to 96) and N is tiled above 96. BN narrows where
//   the B tile would not fit in shared memory, and where narrower tiles
//   still number at most two a SM (VA conv5 and conv6, whose few M tiles
//   would leave each block a long serial chain). A BN-wide MMA is one or two
//   wgmma of the widths 8, 16, 32 and 64 (96 = 64 + 32, 48 = 32 + 16,
//   24 = 16 + 8).
// - A streams through a ring: the block is persistent (the grid is the
//   blocks the card holds at once, from the occupancy query) and walks 64-row
//   M tiles, each as K chunks of 64 x 32 floats, through kStages cp.async
//   slots, each completing on its own mbarrier. The loads of the next chunks
//   (of this tile or the next) are in flight while a chunk's MMAs run and a
//   tile's epilogue stores. What a slot holds is zero outside A's valid rows
//   and columns (cp.async with src-size 0), so the group padding of K meets
//   finite zeros and not 0 * NaN.
// - a short kernel's time is mostly latency, so nothing waits that need not:
//   the strip's loads go out first, the first chunks' copies right after,
//   and the tile's scale is staged before the first chunk, not loaded by
//   the epilogue.
// - nm_spmm and sparse_conv1d run the same instantiation on the same plan
//   for the same (M, K, N), so the fused layer is bit-identical to im2col ->
//   pad -> nm_spmm: the same values land in the same slots and meet the same
//   chain of MMAs.

#pragma once

#include "cmul_tc.cuh"

namespace spe {

using cmul::kBK;
using cmul::kBM;
using cmul::kThreads;
using cmul::kXS;
using cmul::kXsBytes;

constexpr int kStages = 4;  // ring depth: chunks of A in flight
// the instantiated tile widths, narrowest first
constexpr int kWidths[] = {8, 16, 24, 32, 48, 64, 96};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on H100
// a segmented strip's budget with the ring: two blocks an SM (of its 228 KB,
// each block also keeps 1 KB for the system)
constexpr int kSegSmem = 114688;

// a BN-wide MMA as two wgmma widths: W0 + W1 == BN, W1 in {0, 8, 16, 32}
__host__ __device__ constexpr int w0(int bn) {
  return bn >= 64 ? 64 : bn >= 32 ? 32 : bn >= 16 ? 16 : 8;
}
__host__ __device__ constexpr int w1(int bn) { return bn - w0(bn); }

// B tile bytes: one (32 x BN) chunk tile for each 32-wide K chunk
__host__ __device__ constexpr size_t b_bytes(int bn, int nchunks) {
  return static_cast<size_t>(nchunks) * bn * kBK * 4;
}

// the B tile of `chunks` K chunks, the ring, its mbarriers and the tile's
// scale
__host__ __device__ constexpr size_t smem_for(int bn, int chunks) {
  return b_bytes(bn, chunks) + static_cast<size_t>(kStages) * kXsBytes +
         kStages * 8 + bn * 4;
}

// the same with the whole strip of dense K in the B tile
__host__ __device__ constexpr size_t smem_bytes(int bn, int K) {
  return smem_for(bn, (K + kBK - 1) / kBK);
}

// ---- wgmma of the widths cmul_tc.cuh lacks ----------------------------------

__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d += a . B over one 8-wide k-step, B (8 x W) from shared memory
template <int W>
__device__ __forceinline__ void wgmma(float (&d)[W / 2], const uint32_t (&a)[4],
                                      uint64_t desc) {
  if constexpr (W == 8) wgmma_n8(d, a, desc);
  if constexpr (W == 16) wgmma_n16(d, a, desc);
  if constexpr (W == 32) cmul::wgmma_tf32(d, a, desc);
  if constexpr (W == 64) wgmma_n64(d, a, desc);
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One sub-tile of the output: W columns from column kOff of the block's
// tile. Accumulator element i of thread (warp, g, q) is row 16 warp + g +
// 8 ((i / 2) % 2), column kOff + 8 (i / 4) + 2 q + i % 2 (wgmma's layout).
template <int W, int kOff>
struct Part {
  static constexpr int kN = W > 0 ? W / 2 : 1;
  float acc[kN];  // one chunk's sum, on the tensor cores
  float tot[kN];  // the chunks' sums, by FADDs

  __device__ __forceinline__ void clear_tot() {
#pragma unroll
    for (int i = 0; i < kN; ++i) tot[i] = 0.f;
  }
  __device__ __forceinline__ void clear_acc() {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
    fence_operand(acc);
  }
  // both passes of one k-step against the chunk tile at `b` (shared)
  __device__ __forceinline__ void mma(const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], uint32_t b) {
    if constexpr (W > 0) {
      const uint64_t d = cmul::b_desc(b + (kOff / 8) * cmul::kSBO);
      wgmma<W>(acc, hi, d);
      wgmma<W>(acc, lo, d);
    }
  }
  __device__ __forceinline__ void add_chunk() {
    fence_operand(acc);
#pragma unroll
    for (int i = 0; i < kN; ++i) tot[i] += acc[i];
  }
  // y = tot * scale over rows m0.. and columns n0 + kOff.., masked; `sc`
  // is the block's tile of the scale, in shared memory
  __device__ __forceinline__ void store(float* __restrict__ y,
                                        const float* sc, int M, int N, int m0,
                                        int n0, int warp, int g, int q) const {
    if constexpr (W > 0) {
#pragma unroll
      for (int i = 0; i < kN; i += 2) {
        const int m = m0 + 16 * warp + g + 8 * ((i / 2) % 2);
        const int nl = kOff + 8 * (i / 4) + 2 * q;
        const int n = n0 + nl;
        if (m >= M || n >= N) continue;
        float* dst = y + static_cast<size_t>(m) * N + n;
        if (N % 2 == 0) {  // n even, so n + 1 < N and dst 8 B aligned
          *reinterpret_cast<float2*>(dst) =
              make_float2(tot[i] * sc[nl], tot[i + 1] * sc[nl + 1]);
        } else {
          dst[0] = tot[i] * sc[nl];
          if (n + 1 < N) dst[1] = tot[i + 1] * sc[nl + 1];
        }
      }
    }
  }
};

// ---- the kernel ------------------------------------------------------------

// X: `Rows row(int m) const` gives where row m of A lies: element k (dense K
// index) is x[base + k] where lo <= k < hi, else zero (the row is past M, or
// k is SAME or group padding). `vec` bit 0: every lo and hi is a multiple of
// 4 and x + base 16-byte aligned wherever lo <= hi, so 16-byte copies serve;
// bit 1: N is a multiple of 4 and values and select 4-byte aligned.
struct Rows {
  long long base;
  int lo, hi;
};

// kSeg: the strip streams in segments of `seg` 32-wide K chunks, each a
// whole number of groups; else it is decoded whole once (`seg` unused), in
// code free of the segments' bookkeeping.
template <int BN, bool kSeg, class X>
__global__ void __launch_bounds__(kThreads)
spe_tc_kernel(X src, const int8_t* __restrict__ values,
              const uint8_t* __restrict__ select,
              const float* __restrict__ scale, float* __restrict__ y, int M,
              int K, int N, int Kk, int G, int keep, int vec, int seg) {
  constexpr int kChunkBytes = BN * kBK * 4;  // one chunk's B tile
  const int nchunks = (K + kBK - 1) / kBK;
  const int tile_chunks = kSeg ? seg : nchunks;  // the B tile's
  const int tiles_m = (M + kBM - 1) / kBM;
  const int gy = static_cast<int>(gridDim.y);
  const int my_tiles = (tiles_m - static_cast<int>(blockIdx.y) + gy - 1) / gy;
  const int items = my_tiles * nchunks;  // (tile, chunk) pairs, in order

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bt = smem;                                    // B tile
  float* xs = reinterpret_cast<float*>(smem + b_bytes(BN, tile_chunks));
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + kStages * kBM * kXS);
  float* sc = reinterpret_cast<float*>(bars + kStages);  // [BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int q = tid % 4;
  const int n0 = blockIdx.x * BN;

  // item j (tile j / nchunks of this block, chunk j % nchunks) into slot s:
  // every thread issues its copies, then arrives. With 16-byte copies a
  // thread copies the same kVecRows rows in every chunk of a tile, so it
  // asks X where they lie once a tile (sparse_conv1d's X divides by T_out).
  constexpr int kVecRows = kBM * kBK / 4 / kThreads;
  static_assert(kVecRows * kThreads * 4 == kBM * kBK, "16-byte copies");
  Rows rows[kVecRows];
  int rows_tile = -1;
  auto load = [&](int s, int j) {
    const int m0 = (static_cast<int>(blockIdx.y) + (j / nchunks) * gy) * kBM;
    const int k0 = (j % nchunks) * kBK;
    float* xd = xs + s * kBM * kXS;
    if (vec & 1) {
      if (j / nchunks != rows_tile) {
        rows_tile = j / nchunks;
#pragma unroll
        for (int v = 0; v < kVecRows; ++v)
          rows[v] = src.row(m0 + (tid + v * kThreads) / (kBK / 4));
      }
#pragma unroll
      for (int v = 0; v < kVecRows; ++v) {
        const int e = tid + v * kThreads;
        const int r = e / (kBK / 4), k = k0 + 4 * (e % (kBK / 4));
        const bool in = k >= rows[v].lo && k < rows[v].hi;
        cmul::cp_async16(cmul::smem_addr(xd + r * kXS + (k - k0)),
                         in ? src.x + rows[v].base + k : src.x, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, k = k0 + e % kBK;
        const Rows rw = src.row(m0 + r);
        const bool in = k >= rw.lo && k < rw.hi;
        cmul::cp_async4(cmul::smem_addr(xd + r * kXS + (k - k0)),
                        in ? src.x + rw.base + k : src.x, in ? 4 : 0);
      }
    }
    cmul::cp_async_arrive(cmul::smem_addr(&bars[s]));
  };

  // A segment of the strip is decoded once (the whole strip where it fits):
  // the B tile zeroed, then each compressed weight written to its dense row
  // (a group's selects are distinct). It is read kDec units of 4 columns a
  // thread a round (4 bytes a load where `vec` bit 1 says N and the pointers
  // allow it), every load of a round in flight at once; one round covers a
  // VA layer's strip. The first round's loads go out before anything else,
  // so that they neither wait on the set-up nor queue behind the first
  // chunks of A. Segment s holds dense K from k_lo = s * seg * 32, that is
  // compressed rows r_lo = k_lo / G * keep on (k_lo is a multiple of G).
  constexpr int kDec = 12;
  constexpr int kUnitsRow = BN / 4;  // BN is a multiple of 8
  int k_lo = 0, r_lo = 0;
  int units = Kk * kUnitsRow;  // the whole strip's; a segment's below
  auto segment = [&](int s) {
    k_lo = s * seg * kBK;
    r_lo = k_lo / G * keep;
    const int r_hi = (k_lo + seg * kBK) / G * keep;
    units = ((r_hi < Kk ? r_hi : Kk) - r_lo) * kUnitsRow;
  };
  uint32_t sel[kDec], val[kDec];
  auto fetch = [&](int u0) {
#pragma unroll
    for (int j = 0; j < kDec; ++j) {
      const int u = u0 + j * kThreads + tid;
      const int n = n0 + 4 * (u % kUnitsRow);
      const size_t at =
          static_cast<size_t>((kSeg ? r_lo : 0) + u / kUnitsRow) * N + n;
      sel[j] = val[j] = 0;
      if (u >= units || n >= N) continue;
      if (vec & 2) {
        sel[j] = *reinterpret_cast<const uint32_t*>(select + at);
        val[j] = *reinterpret_cast<const uint32_t*>(values + at);
      } else {
        for (int t = 0; t < 4 && n + t < N; ++t) {
          sel[j] |= static_cast<uint32_t>(select[at + t]) << (8 * t);
          val[j] |= static_cast<uint32_t>(static_cast<uint8_t>(values[at + t]))
                    << (8 * t);
        }
      }
    }
  };
  auto scatter = [&](int u0) {
#pragma unroll
    for (int j = 0; j < kDec; ++j) {
      const int u = u0 + j * kThreads + tid;
      const int r = (kSeg ? r_lo : 0) + u / kUnitsRow;
      const int nl = 4 * (u % kUnitsRow);
      if (u >= units) continue;
      const int d0 = (r / keep) * G;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        int d = d0 + static_cast<int>((sel[j] >> (8 * t)) & 0xFFu);
        if (n0 + nl + t >= N || d >= K) continue;
        if constexpr (kSeg) d -= k_lo;  // the row in the segment's tile
        const int kl = d % kBK;
        *reinterpret_cast<float*>(bt + (d / kBK) * kChunkBytes +
                                  ((nl + t) / 8) * cmul::kSBO +
                                  (kl / 4) * cmul::kLBO +
                                  ((nl + t) % 8) * 16 + (kl % 4) * 4) =
            static_cast<float>(static_cast<int8_t>(val[j] >> (8 * t)));
      }
    }
  };

  auto zero_b = [&]() {
    float4* z = reinterpret_cast<float4*>(bt);
    const int n4 = static_cast<int>(b_bytes(BN, tile_chunks) / 16);
    for (int e = tid; e < n4; e += kThreads) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  };

  if constexpr (kSeg) segment(0);
  fetch(0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      cmul::mbar_init(cmul::smem_addr(&bars[s]), kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tile's scale, staged now so that no tile's stores wait on its load
  for (int e = tid; e < BN; e += kThreads)
    sc[e] = n0 + e < N ? scale[n0 + e] : 0.f;
  zero_b();
  __syncthreads();  // barriers initialised, B zero
  for (int i = 0; i < kStages && i < items; ++i) load(i, i);
  scatter(0);
  for (int u0 = kThreads * kDec; u0 < units; u0 += kThreads * kDec) {
    fetch(u0);
    scatter(u0);
  }
  // B visible to the tensor cores' (async) proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  Part<w0(BN), 0> p0;
  Part<w1(BN), w0(BN)> p1;
  p0.clear_tot();
  p1.clear_tot();
  const uint32_t b_base = cmul::smem_addr(bt);
  int c0 = 0;  // the chunk the B tile's segment starts at

  for (int i = 0; i < items; ++i) {
    const int s = i % kStages;
    const int c = i % nchunks;
    if constexpr (kSeg) {
      if (c % seg == 0 && i > 0) {
        // the next segment of the strip (the first again, for the next M
        // tile); the copies of A already issued stay in flight meanwhile
        __syncthreads();  // every warp's MMAs on the last segment are done
        c0 = c;
        segment(c / seg);
        zero_b();
        __syncthreads();
        for (int u0 = 0; u0 < units; u0 += kThreads * kDec) {
          fetch(u0);
          scatter(u0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
    }
    cmul::mbar_wait(cmul::smem_addr(&bars[s]), (i / kStages) & 1);

    // this thread's A fragments, split into TF32 high and low parts
    const float* xr = xs + s * kBM * kXS + (16 * warp + g) * kXS + q;
    uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float a[4] = {xr[8 * kk], xr[8 * kXS + 8 * kk], xr[8 * kk + 4],
                          xr[8 * kXS + 8 * kk + 4]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[kk][j] = cmul::tf32_rna(a[j]);
        lo[kk][j] = cmul::tf32_rna(a[j] - __uint_as_float(hi[kk][j]));
      }
    }
    __syncthreads();  // every thread has its fragments: slot s is free
    if (i + kStages < items) load(s, i + kStages);

    p0.clear_acc();
    p1.clear_acc();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint32_t b =
          b_base + (kSeg ? c - c0 : c) * kChunkBytes + kk * 2 * cmul::kLBO;
      p0.mma(hi[kk], lo[kk], b);
      p1.mma(hi[kk], lo[kk], b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    p0.add_chunk();
    p1.add_chunk();

    if (c == nchunks - 1) {  // the tile's last chunk: scale and store
      const int m0 = (static_cast<int>(blockIdx.y) + (i / nchunks) * gy) * kBM;
      p0.store(y, sc, M, N, m0, n0, warp, g, q);
      p1.store(y, sc, M, N, m0, n0, warp, g, q);
      p0.clear_tot();
      p1.clear_tot();
    }
  }
}

// ---- host side -------------------------------------------------------------

struct Plan {
  dim3 grid;
  int bn;
  int smem;
  int per_sm;  // blocks of this kernel an SM holds at once
  int seg;     // K chunks a segment of the strip (all of them where it fits)
  bool segmented;  // the strip streams in segments (kernel_for)
};

template <class X>
using KernelFn = void (*)(X, const int8_t*, const uint8_t*, const float*,
                          float*, int, int, int, int, int, int, int, int);

// The instantiation for tile width bn; with `seg`, the segmented one (8 and
// 24 wide only, and only for an X whose kSegments says it streams: the
// fused layer takes a whole strip, as its reference does).
template <class X>
KernelFn<X> kernel_for(int bn, bool seg) {
  if constexpr (X::kSegments) {
    if (seg) return bn == 8 ? spe_tc_kernel<8, true, X> : spe_tc_kernel<24, true, X>;
  }
  switch (bn) {
    case 8: return spe_tc_kernel<8, false, X>;
    case 16: return spe_tc_kernel<16, false, X>;
    case 24: return spe_tc_kernel<24, false, X>;
    case 32: return spe_tc_kernel<32, false, X>;
    case 48: return spe_tc_kernel<48, false, X>;
    case 64: return spe_tc_kernel<64, false, X>;
    default: return spe_tc_kernel<96, false, X>;
  }
}

// the segmented kernel's widths (kernel_for)
constexpr int kSegWidths[] = {8, 24};

// The index in kWidths of the width that covers no more than N needs: the
// narrowest >= N, or the widest.
inline int natural_width(int N) {
  int j = 0;
  while (j + 1 < kNumWidths && kWidths[j] < N) ++j;
  return j;
}

// The index in kWidths of the widest width up to `natural_width` whose
// whole B tile and ring fit in a block's shared memory at this K; the
// narrowest where none fits.
inline int fit_width(int K, int N) {
  int j = natural_width(N);
  while (j > 0 && smem_bytes(kWidths[j], K) > static_cast<size_t>(kMaxSmem))
    --j;
  return j;
}

// The dynamic shared memory of a launch at (K, N) with the whole strip in
// the B tile: over the limit where no width fits.
inline size_t fit_smem(int K, int N) {
  return smem_bytes(kWidths[fit_width(K, N)], K);
}

// K chunks in the shortest segment of whole groups and whole chunks:
// lcm(G, 32) / 32.
inline int seg_unit(int G) {
  int a = G, b = kBK;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return G / a;
}

// K chunks a segment at width bn: the most whole units whose B tile, with
// the ring, fits in kSegSmem; one unit at least.
inline int seg_chunks(int bn, int G) {
  const int unit = seg_unit(G);
  const long long room =
      static_cast<long long>(kSegSmem) - static_cast<long long>(smem_for(bn, 0));
  const long long n = room / static_cast<long long>(b_bytes(bn, unit));
  return static_cast<int>(n > 1 ? n : 1) * unit;
}

// The least dynamic shared memory a launch at (K, N) with group G takes:
// the whole strip's where it fits, else one segment's at the narrowest
// width. Over the limit only where not even one segment fits.
inline size_t least_smem(int K, int N, int G) {
  const size_t whole = fit_smem(K, N);
  if (whole <= static_cast<size_t>(kMaxSmem)) return whole;
  return smem_for(kWidths[0], seg_chunks(kWidths[0], G));
}

// The tile width and grid of one launch on the current card. Where the
// whole strip fits, BN starts at `fit_width`'s; else at `natural_width`'s,
// the strip in segments (`seg_chunks`; an X without kSegments refuses).
// Then it narrows while halving it keeps the tiles within two a SM (VA
// conv5: 128 M tiles at BN 64 become 256 at BN 32; conv6: 64 at BN 96
// become 256 at BN 24; qwen3-8b's down projection at M <= 64: 43 tiles at
// BN 96 become 171 at BN 24), so a block's chain (strip, chunks, stores)
// shortens; a segmented plan then takes the widest of kSegWidths not past
// it. The grid is the blocks the card holds at once, or the tiles where
// they are fewer; a block walks M tiles gridDim.y apart. Sets the kernel's
// shared-memory limit, which the occupancy query and the launch need.
template <class X>
cudaError_t plan(int M, int K, int N, int G, Plan* pl) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (least_smem(K, N, G) > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const int nchunks = (K + kBK - 1) / kBK;
  const bool whole = fit_smem(K, N) <= static_cast<size_t>(kMaxSmem);
  if (!whole && !X::kSegments) return cudaErrorInvalidValue;
  int j = whole ? fit_width(K, N) : natural_width(N);
  const long long tiles_m = (M + kBM - 1) / kBM;
  auto tiles = [&](int w) { return tiles_m * ((N + w - 1) / w); };
  while (j > 0) {
    int h = j;  // the widest width <= half of this one
    while (h > 0 && kWidths[h] * 2 > kWidths[j]) --h;
    if (kWidths[h] * 2 > kWidths[j] || tiles(kWidths[h]) > 2 * sms) break;
    j = h;
  }
  pl->bn = kWidths[j];
  if (!whole) {
    pl->bn = pl->bn >= kSegWidths[1] ? kSegWidths[1] : kSegWidths[0];
    if (smem_for(pl->bn, seg_chunks(pl->bn, G)) >
        static_cast<size_t>(kMaxSmem))
      pl->bn = kSegWidths[0];  // a group too long for one segment at 24
  }
  pl->segmented = !whole;
  pl->seg = whole ? nchunks : seg_chunks(pl->bn, G);
  if (pl->seg > nchunks) pl->seg = nchunks;
  pl->smem = static_cast<int>(smem_for(pl->bn, pl->seg));
  const KernelFn<X> fn = kernel_for<X>(pl->bn, pl->segmented);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl->per_sm, fn,
                                                        kThreads, pl->smem);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + pl->bn - 1) / pl->bn;
  const long long wave = static_cast<long long>(sms) * pl->per_sm;
  long long gy = wave / tiles_n;
  if (gy < 1) gy = 1;
  if (gy > tiles_m) gy = tiles_m;
  if (gy > cmul::kMaxGridY) gy = cmul::kMaxGridY;
  pl->grid = dim3(tiles_n, static_cast<unsigned>(gy), 1);
  return cudaSuccess;
}

// Checks the shape, launches on `stream` and returns the CUDA error (0 on
// success): a launch the card refuses is returned, never replaced. `vec` is
// 1 where the caller's A allows 16-byte copies (X's bit 0), else 0.
template <class X>
int launch(const X& src, const void* values, const void* select,
           const void* scale, void* y, int M, int K, int N, int Kk, int G,
           int keep, int vec, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K <= 0 || Kk <= 0 || keep <= 0 || G <= 0 || Kk % keep ||
      K != (Kk / keep) * G)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = plan<X>(M, K, N, G, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(select) % 4 == 0)
    vec |= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = pl.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel_for<X>(pl.bn, pl.segmented), src,
                           static_cast<const int8_t*>(values),
                           static_cast<const uint8_t*>(select),
                           static_cast<const float*>(scale),
                           static_cast<float*>(y), M, K, N, Kk, G, keep, vec,
                           pl.seg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out = {grid.x, grid.y, grid.z, cluster size, dynamic shared memory bytes,
// blocks an SM holds, BN, dense K a segment}; returns the CUDA error (0 on
// success)
template <class X>
int geometry(int M, int K, int N, int G, int* out) {
  Plan pl;
  const cudaError_t err = plan<X>(M, K, N, G, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.grid.x;
  out[1] = pl.grid.y;
  out[2] = pl.grid.z;
  out[3] = 1;
  out[4] = pl.smem;
  out[5] = pl.per_sm;
  out[6] = pl.bn;
  out[7] = pl.seg * kBK;
  return 0;
}

}  // namespace spe
