// Valid 2-D convolution with one output channel (the paper pool's 3x7x7
// fconv2d), written for Hopper (sm_90a).
//
// Replaces conv2d_pallas (src/repro/kernels/conv2d.py:31, kernel body
// _conv2d_kernel at lines 18-27): x (C, H, W) and one filter w (C, k, k), both
// fp32 or both bf16, give out (H-k+1, W-k+1) in x's type,
//   out[i, j] = sum over ci, ki, kj of w[ci, ki, kj] * x[ci, i+ki, j+kj],
// with fp32 sums.  Any C >= 1, H, W >= k and k >= 1 (the Pallas kernel
// asserts that its 8-row blocks divide H-k+1, which bench_ideality's own
// 3x128x128 does not).
//
// What bounds it on the H100: bytes.  At 3 x 4096 x 4096, k = 7 it reads
// 201 MB and writes 67 MB in fp32, 0.080 ms at 3.35 TB/s (bf16: 0.040 ms),
// against 4.9 GFLOP, 0.073 ms at the fp32 CUDA-core peak.  The first kernel
// (one shared-memory load per tap and output) was held by shared-memory
// bandwidth at ~0.49 ms in both types.  Two routes, by type:
//
// bf16, `mma`: the convolution as a banded (Toeplitz) product on mma.sync
//   m16n8k16 with fp32 sums.  For one channel ci and filter row ki a 16 x 8
//   output tile out[i0:i0+16, j0:j0+8] gains A B with
//     A[m, kk] = x[ci, i0+m+ki, j0+16s+kk]     (a 16 x 16 window of the tile)
//     B[kk, n] = w[ci, ki, 16s+kk-n]           (0 outside 0 <= 16s+kk-n < k)
//   over K-steps s < ceil((k+7)/16), one for k <= 9.  A warp owns 16 rows by
//   64 columns (8 n-tiles); adjacent n-tiles share an 8-column half of A, so
//   a step loads 9 halves by ldmatrix and runs 8 products, the next step's
//   A and B loaded before this step's products.  B never comes from device
//   memory in the loop: each lane's fragment of every (ci, ki, s) is built
//   once a block into a table in shared memory (taps from w where it does
//   not fit, C k steps > 96).  For k = 7, the pool's filter, the filter
//   rows are unrolled (a kernel of its own).  bf16 x bf16 products are exact in fp32; only
//   the order of the fp32 sums differs from the oracle's tap loop.  A zero
//   of B times a NaN or inf of A outside an output's window would poison
//   that output, so a block whose sums are not all finite recomputes its
//   tile tap by tap (ci, ki, kj) from device memory: the plain version's
//   bits, NaN exactly where an output's window covers one.  Finite inputs
//   never take it.  The finished tile leaves through shared memory, a warp
//   a row, so its stores are whole lines.
//
// fp32, `simt`: a register-blocked direct convolution on CUDA cores, no TF32.
//   A thread owns 8 rows by 4 columns of outputs.  It walks its input tile's
//   rows from top to bottom; each row's 4+k-1 values come from shared memory
//   in 16-byte loads, a row ahead, and feed every output row they reach (ki
//   = r - i), so a loaded value serves up to 8 k FMAs instead of one.  For
//   k = 7 the filter of a channel sits in registers (a kernel of its own);
//   any other k walks the taps in chunks of 8 with the weights from L1.
//   Each output takes its fmaf chain in the order ci, ki, kj, as the first
//   kernel did, so its bits are that kernel's.
//
// Both routes: persistent blocks of 256 threads, as many as fit the card,
// walk 64 x 128 output tiles; each channel of a tile is an item, its input
// tile (64+k-1 rows, the halo and zeros past the edges included) staged in
// a ring of shared memory two (bf16) or one (fp32) items ahead, by the
// tensor memory accelerator where rows start on 16 bytes, else by cp.async
// (fp32) or element loads (bf16).  Shared memory does not grow with C;
// above 48 KB it is opted in.  One launch a call.
//
// A filter whose input tile does not fit a stage (or a TMA box of 256 rows
// and 256 columns) is walked in bands that fit, each band an item of its
// own, accumulating in the same registers: bands of kb filter rows (the
// staged tile 64+kb-1 rows), and where even one filter row is too wide, one
// row a band in bands of kw columns (fp32: kw taps; bf16: kw K-steps of
// the banded product).  Items go channel, row band, column band, so the
// fp32 route still takes each output's fmaf chain in the order ci, ki, kj.
// The host picks kb and kw (conv2d.bands); a filter that fits takes one
// band, the kernel as it was.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using tc::bf16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kMaxBox = 256;           // a TMA box's largest side, elements

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(tc::smem_u32(bar)) : "memory");
}

// spin until the barrier's phase of the given parity has completed; a wait
// of more than ~10 s (2^34 cycles) traps, so a lost copy ends the launch
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(tc::smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One channel's tile by the tensor memory accelerator: a box of the (C, H, W)
// tensor map at (x0, y0, ci), zeros past its edges; completion on bar.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         uint32_t bytes, int x0, int y0, int ci) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc::smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(tc::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(tc::smem_u32(bar)), "r"(x0), "r"(y0), "r"(ci)
      : "memory");
}

// The same tile where rows do not start on 16 bytes (W not a multiple of 16
// bytes): fp32 by 4-byte cp.async, bf16 element by element; zeros past the
// edges.
template <typename T>
__device__ __forceinline__ void copy_tile(T* tile, const T* __restrict__ x, int ci, int h,
                                          int wd, int oy0, int ox0, int rows, int pitch) {
  const T* xc = x + static_cast<size_t>(ci) * h * wd;
  for (int e = threadIdx.x; e < rows * pitch / 2; e += kThreads) {
    const int r = e / (pitch / 2), c = 2 * (e - r * (pitch / 2));
    const int gy = oy0 + r, gx = ox0 + c;
    const T* src = xc + static_cast<size_t>(gy) * wd + gx;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = gy < h && gx + j < wd;
        cp_async4(tc::smem_u32(tile + r * pitch + c + j), ok ? src + j : x, ok);
      }
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      const uint32_t lo = (gy < h && gx < wd) ? s[0] : 0u;
      const uint32_t hi = (gy < h && gx + 1 < wd) ? s[1] : 0u;
      *reinterpret_cast<uint32_t*>(tile + r * pitch + c) = lo | hi << 16;
    }
  }
}

// The bands of a filter: kb filter rows by kw column units (fp32: taps,
// bf16: K-steps of 16), `units` of them in a filter row, `col_step` input
// columns from one column band to the next.
struct Bands {
  int kb, kw, rbands, cbands, col_step;
  __host__ __device__ Bands(int k, int kb_, int kw_, int units, int col_step_)
      : kb(kb_), kw(kw_), rbands((k + kb_ - 1) / kb_), cbands((units + kw_ - 1) / kw_),
        col_step(col_step_) {}
  __host__ __device__ int count() const { return rbands * cbands; }
};

// The work of a block: TH x TW output tiles blockIdx.x, + gridDim.x, ...,
// each (channel, row band, column band) of each an item, in that order.
template <int TH, int TW>
struct Walk {
  int channels, per_tile, tiles_x, items;
  Bands bands;
  __device__ Walk(int channels_, const Bands& bands_, int ho, int wo)
      : channels(channels_), per_tile(channels_ * bands_.count()), bands(bands_) {
    tiles_x = (wo + TW - 1) / TW;
    const int tiles = tiles_x * ((ho + TH - 1) / TH);
    items = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x * per_tile;
  }
  // item n's tile origin (oy0, ox0)
  __device__ int2 origin(int n) const {
    const int tile = blockIdx.x + n / per_tile * gridDim.x;
    return make_int2(tile / tiles_x * TH, tile % tiles_x * TW);
  }
  // item n's channel, row band and column band
  __device__ int channel(int n) const { return n % per_tile / bands.count(); }
  __device__ int rband(int n) const { return n % per_tile % bands.count() / bands.cbands; }
  __device__ int cband(int n) const { return n % per_tile % bands.count() % bands.cbands; }
  // the tile's last item
  __device__ bool last(int n) const { return n % per_tile == per_tile - 1; }
};

// A ring of kStages tiles (rows x pitch of T, 128-byte aligned), items
// copied kStages - 1 ahead: by TMA, one thread a copy and an mbarrier a
// stage, where rows start on 16 bytes; else by every thread (copy_tile).
// Shared memory: [kStages mbarriers | 128 - 8 kStages pad | head bytes |
// the stages].
template <typename T, int kStages>
struct Ring {
  static constexpr int kHead = 128;
  uint64_t* full;
  T* base;
  int rows, pitch, stride;   // stride: elements from one stage to the next
  bool tma;

  static __host__ __device__ constexpr int stage_elems(int rows, int pitch) {
    return (rows * pitch * static_cast<int>(sizeof(T)) + 127) / 128 * 128 /
           static_cast<int>(sizeof(T));
  }
  static __host__ __device__ constexpr int bytes(int head, int rows, int pitch) {
    return kHead + head + kStages * stage_elems(rows, pitch) * static_cast<int>(sizeof(T));
  }
  // smem 128-byte aligned; `head` bytes (a multiple of 128) before the stages
  __device__ Ring(unsigned char* smem, int head, int rows_, int pitch_, bool tma_)
      : full(reinterpret_cast<uint64_t*>(smem)),
        base(reinterpret_cast<T*>(smem + kHead + head)), rows(rows_), pitch(pitch_),
        stride(stage_elems(rows_, pitch_)), tma(tma_) {
    if (tma && threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __device__ T* stage(int n) const { return base + (n % kStages) * stride; }

  // start item n's copy (none past the last item): its band's rows and
  // columns of its channel; call with every thread
  template <typename W>
  __device__ void issue(const W& walk, int n, const CUtensorMap* map, const T* x, int h,
                        int wd) const {
    if (n >= walk.items) return;
    const int2 o = walk.origin(n);
    const int ci = walk.channel(n);
    const int oy = o.x + walk.rband(n) * walk.bands.kb;
    const int ox = o.y + walk.cband(n) * walk.bands.col_step;
    if (!tma) {
      copy_tile(stage(n), x, ci, h, wd, oy, ox, rows, pitch);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else if (threadIdx.x == 0) {
      tma_tile(stage(n), map, &full[n % kStages],
               rows * pitch * static_cast<uint32_t>(sizeof(T)), ox, oy, ci);
    }
  }
  // wait for item n, then a barrier: every thread sees it, and every
  // thread is past item n-1, whose stage the next issue refills
  __device__ void wait(int n, int items) const {
    if (tma) {
      mbar_wait(&full[n % kStages], (n / kStages) & 1);
    } else if (n + kStages - 1 <= items) {     // later items' copies may be pending
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// bf16: the banded product on tensor cores.
// ---------------------------------------------------------------------------

constexpr int kTilesW = 8;             // n8 tiles a warp: 64 columns
constexpr int kMmaWarpRows = 4;        // warps: 4 x 16 rows by 2 x 64 columns
constexpr int kMmaTileH = 16 * kMmaWarpRows, kMmaTileW = 8 * kTilesW * (8 / kMmaWarpRows);
constexpr int kHalves = kTilesW + 1;   // 8-column halves of A a step loads
constexpr int kMmaStages = 3;          // items in the ring: 2 in flight

__host__ __device__ constexpr int mma_steps(int k) { return (k + 7 + 15) / 16; }
// columns of the staged tile for a band of `steps` K-steps: the last warp's
// last step reaches 8 (kTilesW + 2 steps - 1) past its origin; pitch * 2
// bytes is an odd multiple of 16 modulo 128 for every band, so ldmatrix's 8
// rows fall in distinct banks
__host__ __device__ constexpr int mma_pitch(int steps) { return kMmaTileW + 16 * steps - 8; }
// the output tile's pitch when it passes through a stage: rows 16 bytes
// apart in the banks, so a warp's fragment stores do not collide
constexpr int kOutPitch = kMmaTileW + 8;
// the B table: a uint2 a lane for every (ci, ki, s), when it fits 24 KB
constexpr int kTableSteps = 96;
__host__ __device__ constexpr bool mma_table_fits(int channels, int k) {
  return channels <= kTableSteps && channels * k * mma_steps(k) <= kTableSteps;
}
__host__ __device__ constexpr int mma_table_bytes(int channels, int k) {
  return channels * k * mma_steps(k) * 32 * static_cast<int>(sizeof(uint2));
}
using MmaRing = Ring<bf16, kMmaStages>;
// kb filter rows and kw K-steps a band
__host__ __device__ constexpr int mma_smem(int channels, int k, int kb, int kw) {
  return 128 + MmaRing::bytes(mma_table_fits(channels, k) ? mma_table_bytes(channels, k) : 0,
                              kMmaTileH + kb - 1, mma_pitch(kw));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// tap c of a filter row, 0 outside it: B's entries
__device__ __forceinline__ uint32_t tap(const uint16_t* __restrict__ row, int c, int k) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(k) ? __ldg(row + c) : 0u;
}

// a thread's B fragment of one step: B[2t, 2t+1; g] and B[2t+8, 2t+9; g],
// c0 = 16 s + 2t - g
__device__ __forceinline__ void taps(const uint16_t* __restrict__ row, int c0, int k,
                                     uint32_t& b0, uint32_t& b1) {
  b0 = tap(row, c0, k) | tap(row, c0 + 1, k) << 16;
  b1 = tap(row, c0 + 8, k) | tap(row, c0 + 9, k) << 16;
}

// out[oy, ox] of the block's tile, tap by tap in the oracle's order
__device__ __noinline__ void conv2d_taps_bf16(const bf16* __restrict__ x,
                                              const bf16* __restrict__ w,
                                              bf16* __restrict__ out, int channels,
                                              int h, int wd, int k, int oy0, int ox0) {
  const int ho = h - k + 1, wo = wd - k + 1;
  for (int e = threadIdx.x; e < kMmaTileH * kMmaTileW; e += kThreads) {
    const int oy = oy0 + e / kMmaTileW, ox = ox0 + e % kMmaTileW;
    if (oy >= ho || ox >= wo) continue;
    float acc = 0.f;
    for (int ci = 0; ci < channels; ++ci)
      for (int ki = 0; ki < k; ++ki) {
        const bf16* xr = x + (static_cast<size_t>(ci) * h + oy + ki) * wd + ox;
        const bf16* wr = w + (static_cast<size_t>(ci) * k + ki) * k;
        for (int kj = 0; kj < k; ++kj)
          acc = fmaf(__bfloat162float(wr[kj]), __bfloat162float(xr[kj]), acc);
      }
    out[static_cast<size_t>(oy) * wo + ox] = __float2bfloat16(acc);
  }
}

// A's 9 halves of one step at `a` (the lane's ldmatrix row and column)
__device__ __forceinline__ void mma_halves(uint32_t (&hv)[kHalves][2], const bf16* a,
                                           int lhalf) {
#pragma unroll
  for (int q = 0; q < kHalves / 2; ++q) {
    uint32_t r[4];
    tc::ldsm_x4(r, tc::smem_u32(a + 8 * (2 * q + lhalf)));
    hv[2 * q][0] = r[0];
    hv[2 * q][1] = r[1];
    hv[2 * q + 1][0] = r[2];
    hv[2 * q + 1][1] = r[3];
  }
  ldsm_x2(hv[kHalves - 1], tc::smem_u32(a + 8 * (kHalves - 1)));
}

// the 8 n-tiles' products of one step: tile p reads halves p and p + 1
__device__ __forceinline__ void mma_tiles(float (&acc)[kTilesW][4],
                                          const uint32_t (&hv)[kHalves][2], uint2 b) {
#pragma unroll
  for (int p = 0; p < kTilesW; ++p) {
    const uint32_t af[4] = {hv[p][0], hv[p][1], hv[p + 1][0], hv[p + 1][1]};
    tc::mma16816(acc[p], af, b.x, b.y);
  }
}

// step (ki, s)'s B fragment: from the block's table, or from w
__device__ __forceinline__ uint2 mma_b(const uint2* btab, const uint16_t* __restrict__ wc,
                                       int ki, int s, int steps, int c0, int k, int lane) {
  if (btab) return btab[(ki * steps + s) * 32 + lane];
  uint2 b;
  taps(wc + ki * k, 16 * s + c0, k, b.x, b.y);
  return b;
}

// One band of one channel of a warp's 16 x 64 outputs: its (ki, s) steps in
// order, filter rows k0 + [0, kbn) and K-steps s0 + [0, sn).  `a` is the
// lane's ldmatrix row at the band's first row and step; c0 = 2t - g; `btab`
// the channel's B fragments, or null.  K > 0: k = K <= 9, one band, one step
// a filter row, unrolled, the next step's A and B loaded before this step's
// products; K = 0: any k, B a step ahead.
template <int K>
__device__ __forceinline__ void mma_channel(float (&acc)[kTilesW][4], const bf16* a,
                                            int pitch, int lhalf, const uint2* btab,
                                            const uint16_t* __restrict__ wc, int c0,
                                            int k, int lane, int k0, int kbn, int s0,
                                            int sn) {
  uint32_t hv[2][kHalves][2];
  if constexpr (K > 0) {
    mma_halves(hv[0], a, lhalf);
    uint2 b = mma_b(btab, wc, 0, 0, 1, c0, K, lane);
#pragma unroll
    for (int ki = 0; ki < K; ++ki) {
      uint2 nb = b;
      if (ki + 1 < K) {
        mma_halves(hv[(ki + 1) & 1], a + (ki + 1) * pitch, lhalf);
        nb = mma_b(btab, wc, ki + 1, 0, 1, c0, K, lane);
      }
      mma_tiles(acc, hv[ki & 1], b);
      b = nb;
    }
  } else {
    const int steps = mma_steps(k);
    uint2 b = mma_b(btab, wc, k0, s0, steps, c0, k, lane);
    for (int ki = 0, s = 0; ki < kbn;) {
      int nki = ki, ns = s + 1;
      if (ns == sn) ns = 0, ++nki;
      uint2 nb = b;
      if (nki < kbn) nb = mma_b(btab, wc, k0 + nki, s0 + ns, steps, c0, k, lane);
      mma_halves(hv[0], a + ki * pitch + 16 * s, lhalf);
      mma_tiles(acc, hv[0], b);
      b = nb, ki = nki, s = ns;
    }
  }
}

// Every (ci, ki, s) step's B fragment, a uint2 a lane, into `btab`.
__device__ __forceinline__ void mma_table(uint2* btab, const uint16_t* __restrict__ w,
                                          int channels, int k) {
  const int steps = mma_steps(k);
  for (int e = threadIdx.x; e < channels * k * steps * 32; e += kThreads) {
    const int lane = e & 31, q = e >> 5, s = q % steps, row = q / steps;
    uint2 b;
    taps(w + static_cast<size_t>(row) * k, 16 * s + 2 * (lane & 3) - (lane >> 2), k,
         b.x, b.y);
    btab[e] = b;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
conv2d_mma_kernel(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ x,
                  const bf16* __restrict__ w, bf16* __restrict__ out, int channels,
                  int h, int wd, int k, int kb, int kw, bool tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  // [the ring's barriers | B table, when it fits | the ring's stages]
  const bool table = mma_table_fits(channels, k);
  uint2* btab = reinterpret_cast<uint2*>(smem + MmaRing::kHead);
  const int pitch = mma_pitch(kw), rows = kMmaTileH + kb - 1;
  const int steps = mma_steps(k);
  const MmaRing ring(smem, table ? mma_table_bytes(channels, k) : 0, rows, pitch, tma);
  const int ho = h - k + 1, wo = wd - k + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kMmaWarpRows * 16, wc = warp / kMmaWarpRows * (8 * kTilesW);
  // the row and column this lane hands ldmatrix: lanes 8-15 and 24-31 the
  // window's rows 8-15, lanes 16-31 the next half
  const int lrow = (lane & 7) + (lane & 8), lhalf = lane >> 4;
  const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w);
  const Walk<kMmaTileH, kMmaTileW> walk(channels, Bands(k, kb, kw, steps, 16 * kw), ho, wo);
  if (table) mma_table(btab, w16, channels, k);   // seen after the first barrier
  __syncthreads();                                  // the barriers initialised

  float acc[kTilesW][4];
#pragma unroll
  for (int p = 0; p < kTilesW; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;

#pragma unroll
  for (int n = 0; n < kMmaStages - 1; ++n) ring.issue(walk, n, &map, x, h, wd);
  for (int n = 0; n < walk.items; ++n) {
    ring.wait(n, walk.items);
    ring.issue(walk, n + kMmaStages - 1, &map, x, h, wd);
    const int ci = walk.channel(n), k0 = walk.rband(n) * kb, s0 = walk.cband(n) * kw;
    mma_channel<K>(acc, ring.stage(n) + (wr + lrow) * pitch + wc, pitch, lhalf,
                   table ? btab + ci * k * steps * 32 : nullptr,
                   w16 + static_cast<size_t>(ci) * k * k, 2 * t - g, k, lane, k0,
                   min(kb, k - k0), s0, min(kw, steps - s0));
    if (!walk.last(n)) continue;

    // the tile's last item: write it out
    const int2 o = walk.origin(n);
    bool bad = false;
#pragma unroll
    for (int p = 0; p < kTilesW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) bad |= !isfinite(acc[p][e]);
    if (__syncthreads_or(bad)) {
      conv2d_taps_bf16(x, w, out, channels, h, wd, k, o.x, o.y);
    } else {
      // through the stage just read (every warp is past it): the tile in
      // bf16, then whole rows out, a warp a row
      bf16* ot = ring.stage(n);
#pragma unroll
      for (int p = 0; p < kTilesW; ++p)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(ot + (wr + g + 8 * half) * kOutPitch + wc +
                                             8 * p + 2 * t) =
              __floats2bfloat162_rn(acc[p][2 * half], acc[p][2 * half + 1]);
      __syncthreads();
      for (int r = warp; r < kMmaTileH && o.x + r < ho; r += kThreads / 32) {
        bf16* dst = out + static_cast<size_t>(o.x + r) * wo + o.y;
        const bf16* src = ot + r * kOutPitch;
        const int cols = min(kMmaTileW, wo - o.y);
        for (int c = 2 * lane; c < cols; c += 64) {
          if ((wo & 1) == 0 && c + 1 < cols) {
            *reinterpret_cast<uint32_t*>(dst + c) = *reinterpret_cast<const uint32_t*>(src + c);
          } else {
            dst[c] = src[c];
            if (c + 1 < cols) dst[c + 1] = src[c + 1];
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kTilesW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// fp32: register-blocked on CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kRows = 8;               // outputs a thread: 8 rows x 4 columns
constexpr int kCols = 4;
constexpr int kSimtStages = 2;         // items in the ring: 1 in flight
constexpr int kSimtWarpRows = 8;       // warps: 8 x kRows rows by 1 x 128 columns
constexpr int kSimtTileH = kRows * kSimtWarpRows, kSimtTileW = 32 * kCols * (8 / kSimtWarpRows);

__host__ __device__ constexpr int simt_chunks(int kw) { return (kw + 7) / 8; }
// a thread's 16-byte loads reach 8 chunks + 3 columns past its first column
// (kw: the taps of a band's filter row)
__host__ __device__ constexpr int simt_pitch(int kw) { return kSimtTileW + 8 * simt_chunks(kw); }
using SimtRing = Ring<float, kSimtStages>;
// kb filter rows and kw taps a band
__host__ __device__ constexpr int simt_smem(int kb, int kw) {
  return 128 + SimtRing::bytes(0, kSimtTileH + kb - 1, simt_pitch(kw));
}

// One channel's taps, K known here: the filter in registers, each input row
// loaded (16-byte loads) a row ahead and applied to every output row it
// feeds; rows in order, so each output takes ki, then kj, in order.
template <int K>
__device__ __forceinline__ void simt_channel(float (&acc)[kRows][kCols],
                                             const float* src, int pitch,
                                             const float* __restrict__ wc, int, int,
                                             int, int, int) {
  constexpr int kLoads = (kCols + K - 1 + 3) / 4;
  constexpr int kEnd = kRows + K - 1;
  float wv[K * K];
#pragma unroll
  for (int j = 0; j < K * K; ++j) wv[j] = __ldg(wc + j);
  float xv[2][4 * kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    *reinterpret_cast<float4*>(xv[0] + 4 * q) = *reinterpret_cast<const float4*>(src + 4 * q);
#pragma unroll
  for (int r = 0; r < kEnd; ++r) {
    if (r + 1 < kEnd) {
#pragma unroll
      for (int q = 0; q < kLoads; ++q)
        *reinterpret_cast<float4*>(xv[(r + 1) & 1] + 4 * q) =
            *reinterpret_cast<const float4*>(src + (r + 1) * pitch + 4 * q);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int ki = r - i;
      if (ki < 0 || ki >= K) continue;
#pragma unroll
      for (int kj = 0; kj < K; ++kj)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(wv[ki * K + kj], xv[r & 1][c + kj], acc[i][c]);
    }
  }
}

// Any k, one band: filter rows k0 + [0, kbn) by taps j0 + [0, kwn), a row's
// taps in chunks of 8, the weights from L1; `src` is the thread's first
// column in the band's first staged row.
template <>
__device__ __forceinline__ void simt_channel<0>(float (&acc)[kRows][kCols],
                                                const float* src, int pitch,
                                                const float* __restrict__ wc, int k,
                                                int k0, int kbn, int j0, int kwn) {
  for (int r = 0; r < kRows + kbn - 1; ++r) {
    for (int kb = 0; kb < kwn; kb += 8) {
      float xv[12];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<float4*>(xv + 4 * q) =
            *reinterpret_cast<const float4*>(src + r * pitch + kb + 4 * q);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int ki = r - i;
        if (ki < 0 || ki >= kbn) continue;
        const float* wrow = wc + (k0 + ki) * k + j0 + kb;
#pragma unroll
        for (int kj = 0; kj < 8; ++kj) {
          if (kb + kj >= kwn) break;
          const float wv = __ldg(wrow + kj);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(wv, xv[c + kj], acc[i][c]);
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
conv2d_simt_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                   const float* __restrict__ w, float* __restrict__ out, int channels,
                   int h, int wd, int k, int kb, int kw, bool tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const int pitch = simt_pitch(kw), rows = kSimtTileH + kb - 1;
  const SimtRing ring(smem, 0, rows, pitch, tma);
  const int ho = h - k + 1, wo = wd - k + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the thread's outputs
  const int ty = warp % kSimtWarpRows * kRows, tx = (warp / kSimtWarpRows * 32 + lane) * kCols;
  const Walk<kSimtTileH, kSimtTileW> walk(channels, Bands(k, kb, kw, k, kw), ho, wo);
  __syncthreads();                                  // the barriers initialised

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int n = 0; n < kSimtStages - 1; ++n) ring.issue(walk, n, &map, x, h, wd);
  for (int n = 0; n < walk.items; ++n) {
    ring.wait(n, walk.items);
    ring.issue(walk, n + kSimtStages - 1, &map, x, h, wd);
    const int ci = walk.channel(n), k0 = walk.rband(n) * kb, j0 = walk.cband(n) * kw;
    simt_channel<K>(acc, ring.stage(n) + ty * pitch + tx, pitch,
                    w + static_cast<size_t>(ci) * k * k, k, k0, min(kb, k - k0), j0,
                    min(kw, k - j0));
    if (!walk.last(n)) continue;

    // the tile's last item: write it out
    const int2 o = walk.origin(n);
    const int ox = o.y + tx;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int oy = o.x + ty + i;
      if (oy < ho && ox < wo) {
        float* dst = out + static_cast<size_t>(oy) * wo + ox;
        if (ox + kCols <= wo && (wo & 3) == 0) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else if (ox + kCols <= wo && (wo & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(dst + 2) = make_float2(acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (ox + c < wo) dst[c] = acc[i][c];
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (the library links only the
// CUDA runtime, not libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// What a launch of one kernel asks of the device, kept for the last device
// and shared-memory size it was asked for: the opt-in above 48 KB, and how
// many blocks fit the card at once.
struct Fit {
  int device = -1, smem = -1, blocks = 0;
};

template <typename T>
cudaError_t launch_kernel(void (*kernel)(CUtensorMap, const T*, const T*, T*, int, int,
                                         int, int, int, int, bool),
                          Fit& fit, int tile_h, int tile_w, int pitch, int smem,
                          const void* x, const void* w, void* out, int channels, int h,
                          int wd, int k, int kb, int kw, void* stream) {
  cudaError_t e = cudaSuccess;
  int device = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if (fit.device != device || fit.smem != smem) {
    int sms = 0, per_sm = 0;
    if ((smem > 48 * 1024 &&
         (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem)) != cudaSuccess) ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
      return e;
    fit = Fit{device, smem, sms * per_sm};
  }
  // persistent: as many blocks as fit the card at once, or one a tile
  const int ho = h - k + 1, wo = wd - k + 1;
  const long tiles = static_cast<long>((wo + tile_w - 1) / tile_w) *
                     ((ho + tile_h - 1) / tile_h);
  const int grid = static_cast<int>(tiles < fit.blocks ? tiles : fit.blocks);
  // TMA where rows start on 16 bytes: the base on 16 and W whole 16 bytes;
  // a box is one item's staged tile, (pitch, rows, 1)
  CUtensorMap map{};
  const bool tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && wd * sizeof(T) % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(wd), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(channels)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(wd) * sizeof(T),
                                   static_cast<cuuint64_t>(wd) * h * sizeof(T)};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(pitch),
                               static_cast<cuuint32_t>(tile_h + kb - 1), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (encode == nullptr ||
        encode(&map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
               3, const_cast<void*>(x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  kernel<<<grid < 1 ? 1 : grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      channels, h, wd, k, kb, kw, tma);
  return cudaGetLastError();
}

// Each route: an instance with the pool's 7 x 7 filter unrolled (its only
// filter, always one band), and one for any k and any bands.
cudaError_t launch_simt(const void* x, const void* w, void* out, int channels,
                        int h, int wd, int k, int kb, int kw, void* stream) {
  static thread_local Fit fit[2];
  const int smem = simt_smem(kb, kw), pitch = simt_pitch(kw);
  if (k == 7 && kb == 7 && kw == 7)
    return launch_kernel<float>(conv2d_simt_kernel<7>, fit[0], kSimtTileH, kSimtTileW, pitch,
                                smem, x, w, out, channels, h, wd, k, kb, kw, stream);
  return launch_kernel<float>(conv2d_simt_kernel<0>, fit[1], kSimtTileH, kSimtTileW, pitch,
                              smem, x, w, out, channels, h, wd, k, kb, kw, stream);
}

cudaError_t launch_mma(const void* x, const void* w, void* out, int channels,
                       int h, int wd, int k, int kb, int kw, void* stream) {
  static thread_local Fit fit[2];
  const int smem = mma_smem(channels, k, kb, kw), pitch = mma_pitch(kw);
  if (k == 7 && kb == 7 && kw == mma_steps(7))
    return launch_kernel<bf16>(conv2d_mma_kernel<7>, fit[0], kMmaTileH, kMmaTileW, pitch, smem,
                               x, w, out, channels, h, wd, k, kb, kw, stream);
  return launch_kernel<bf16>(conv2d_mma_kernel<0>, fit[1], kMmaTileH, kMmaTileW, pitch, smem,
                             x, w, out, channels, h, wd, k, kb, kw, stream);
}

}  // namespace

// dtype (x, w and out): 0 = float32 (route simt), 1 = bfloat16 (route mma);
// x (channels, h, wd), w (channels, k, k), out (h-k+1, wd-k+1), contiguous.
// kb: filter rows a band; kw: a band's taps (fp32) or K-steps (bf16) of a
// filter row, several column bands only with one row a band (conv2d.bands).
// Returns the CUDA error of the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int repro_conv2d(int dtype, const void* x, const void* w, void* out,
                            int channels, int h, int wd, int k, int kb, int kw,
                            void* stream) {
  const int units = dtype == 0 ? k : mma_steps(k);
  const int pitch = dtype == 0 ? simt_pitch(kw) : mma_pitch(kw);
  if (channels < 1 || k < 1 || h < k || wd < k || kb < 1 || kb > k || kw < 1 ||
      kw > units || (kw < units && kb != 1) || pitch > kMaxBox ||
      kSimtTileH + kb - 1 > kMaxBox)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_simt(x, w, out, channels, h, wd, k, kb, kw, stream));
    case 1:
      return static_cast<int>(launch_mma(x, w, out, channels, h, wd, k, kb, kw, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
