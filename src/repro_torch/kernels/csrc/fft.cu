// Stockham complex FFT, written for Hopper (sm_90a).
//
// Replaces fft_pallas (src/repro/kernels/fft.py:61, stages _fft_stages at
// lines 35-49): the DFT y[k] = sum_j x[j] exp(-2 pi i j k / n) of a complex
// signal given as two planes (re, im) of length n = 2^t >= 2, fp32 or bf16
// in, fp32 out.  The Pallas kernel holds the whole signal in VMEM; a block
// holds at most 227 KB, so n > 4096 runs as several passes through device
// memory.
//
// The schedule is the reference's: stage s (l = n >> (s+1), m = 2^s) views
// the signal as (2, l, m), a = X[0], b = X[1], and writes (l, 2, m) with
// top = a + b and bot = exp(-i pi j / l) (a - b).  After s stages the signal
// is m interleaved columns of length n / m (column k at positions r m + k),
// each an independent DFT whose output r lands at position r m + k: so the
// last stages of a column can run anywhere, in any block, and q stages from
// stage s are, per group of 2^q elements, one DFT of length 2^q times a
// twiddle (the four-step split).
//
// What bounds it on the H100: bytes.  At n = 2^24 fp32 it reads 134 MB and
// writes 134 MB, 0.080 ms at 3.35 TB/s, against 2.0 GFLOP (5 n log2 n),
// 0.030 ms at the fp32 CUDA-core peak.  Every pass through device memory
// reads and writes the whole signal, so the design cuts the passes:
//   * n <= 4096: one block, the signal in 32 KB of shared memory, every
//     stage in place between two barriers (one launch);
//   * n > 4096: passes of 12 stages (the last one the rest), ceil(t / 12)
//     launches: 2 at n = 2^24.  A block holds J groups of R = 4096 (J = 4:
//     16384 elements, 133 KB of both planes with padding) and takes their
//     DFTs in shared memory.  The first pass reads rows of J adjacent
//     elements n / R apart (cp.async, 16 bytes a copy) and writes one
//     contiguous span; the last reads rows of J adjacent elements m apart
//     (columns of 4096) and writes them as rows of 2 J, a cluster of two
//     blocks storing together (one whole 32-byte sector a row and plane,
//     the partner's columns read through distributed shared memory);
//   * the DFT of 4096 is two radix-64 steps (a rest of radix 2 to 32 for
//     other lengths): a thread holds 64 elements in registers and takes
//     their DFT in place (radix-2 decimation in frequency, unrolled, the
//     bit reversal resolved at compile time), so each step is one trip
//     through shared memory (one read, one write, two barriers), and only
//     the first step needs twiddles between the butterflies; rows are
//     padded by 4 floats every 256 against bank conflicts at power-of-two
//     strides;
//   * twiddles come from sincospif on exact fractions (powers of two below),
//     not from the reference's padded (log2 n, n/2) table, which would be
//     1.6 GB at n = 2^24: each block computes exp(-2 pi i e / R), e < R,
//     into shared memory for its radix steps, and the first pass's
//     exp(-2 pi i j c / n) as the product of two 64-entry tables (c mod 64,
//     c / 64) for each of its J groups.
// What holds it (PERF.md section 6): a pass block needs about 170 KB of
// shared memory, so an SM runs one at a time, and its loads, its DFTs and
// its stores follow one another instead of overlapping: each pass at 2^24
// takes a little over twice a device copy of the same bytes.  A split of
// the 4096-point DFT over the SMs of a cluster, so that two blocks fit an
// SM, is not tried.
// The Python wrapper plans the passes (repro_torch.kernels.fft.plan) and
// launches each one through the entry points below.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kLocalMax = 4096;                  // elements the one-block kernel holds
constexpr int kPer = kLocalMax / 2 / kThreads;   // butterflies a thread, a stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp(-i pi x) for x in [0, 1)
__device__ __forceinline__ void twiddle(float x, float* wr, float* wi) {
  float s, c;
  sincospif(x, &s, &c);
  *wr = c;
  *wi = -s;
}

// ---------------------------------------------------------------------------
// A pass of up to 12 stages through device memory (n > 4096).
// ---------------------------------------------------------------------------

constexpr int kPassElems = 16384;     // elements a pass block holds, at most
constexpr int kPerThread = 64;        // elements a thread holds in a step
constexpr int kMaxLogR = 12;          // stages a pass

// exp(-2 pi i k / 64), k < 32: the twiddles inside a butterfly of up to 64
__device__ __constant__ float kW64[32][2] = {
    {1.0f, 0.0f},
    {0.9951847195625305f, -0.0980171412229538f},
    {0.9807852506637573f, -0.19509032368659973f},
    {0.9569403529167175f, -0.290284663438797f},
    {0.9238795042037964f, -0.3826834261417389f},
    {0.8819212913513184f, -0.4713967442512512f},
    {0.8314695954322815f, -0.5555702447891235f},
    {0.7730104327201843f, -0.6343932747840881f},
    {0.7071067690849304f, -0.7071067690849304f},
    {0.6343932747840881f, -0.7730104327201843f},
    {0.5555702447891235f, -0.8314695954322815f},
    {0.4713967442512512f, -0.8819212913513184f},
    {0.3826834261417389f, -0.9238795042037964f},
    {0.290284663438797f, -0.9569403529167175f},
    {0.19509032368659973f, -0.9807852506637573f},
    {0.0980171412229538f, -0.9951847195625305f},
    {0.0f, -1.0f},
    {-0.0980171412229538f, -0.9951847195625305f},
    {-0.19509032368659973f, -0.9807852506637573f},
    {-0.290284663438797f, -0.9569403529167175f},
    {-0.3826834261417389f, -0.9238795042037964f},
    {-0.4713967442512512f, -0.8819212913513184f},
    {-0.5555702447891235f, -0.8314695954322815f},
    {-0.6343932747840881f, -0.7730104327201843f},
    {-0.7071067690849304f, -0.7071067690849304f},
    {-0.7730104327201843f, -0.6343932747840881f},
    {-0.8314695954322815f, -0.5555702447891235f},
    {-0.8819212913513184f, -0.4713967442512512f},
    {-0.9238795042037964f, -0.3826834261417389f},
    {-0.9569403529167175f, -0.290284663438797f},
    {-0.9807852506637573f, -0.19509032368659973f},
    {-0.9951847195625305f, -0.0980171412229538f}};

template <int P> constexpr int kLog2 =
    P == 64 ? 6 : P == 32 ? 5 : P == 16 ? 4 : P == 8 ? 3 : P == 4 ? 2 : 1;

// c < 2^bits (bits <= 6) with its bits reversed; straight-line code, so a
// constant c folds to a constant index
__host__ __device__ constexpr int bit_reverse(int c, int bits) {
  return (((c & 1) << 5) | ((c & 2) << 3) | ((c & 4) << 1) | ((c & 8) >> 1) |
          ((c & 16) >> 3) | ((c & 32) >> 5)) >> (6 - bits);
}

// The DFT of P values in registers (P = 2 .. 64), in place: radix-2
// decimation in frequency, stage by stage (H = P / 2, P / 4, .., 1), so
// that X_c ends in x[bit_reverse(c)].  A template per stage: every loop
// has a constant trip count and is unrolled, so the values stay in
// registers and need no second array.
template <int P, int H>
__device__ __forceinline__ void dif_stage(float (&xr)[P], float (&xi)[P]) {
#pragma unroll
  for (int b = 0; b < P; b += 2 * H) {
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const int e = k * (32 / H);          // exp(-2 pi i k / (2 H)) = W64^e
      const int ia = b + k, ib = ia + H;
      const float dr = xr[ia] - xr[ib], di = xi[ia] - xi[ib];
      xr[ia] += xr[ib];
      xi[ia] += xi[ib];
      if (e == 0) {
        xr[ib] = dr;
        xi[ib] = di;
      } else {
        xr[ib] = kW64[e][0] * dr - kW64[e][1] * di;
        xi[ib] = kW64[e][0] * di + kW64[e][1] * dr;
      }
    }
  }
  if constexpr (H > 1) dif_stage<P, H / 2>(xr, xi);
}

// Index of (row q, column jj) of a block's J columns in shared memory, rows
// of J contiguous: p = q J + jj, padded by 4 floats every 256 so that the
// first radix-64 step's writes (J = 4 columns, rows 64 apart) fall in
// distinct banks; a 16-byte group of 4 stays whole.
__host__ __device__ constexpr int rm(int p) { return p + ((p >> 8) << 2); }

// The column stride of a block's output in shared memory when each column
// is written as one span (the first pass): a multiple of 4 floats (16-byte
// reads), and 32 / J mod 32 for J < 8, so the last radix step's writes (J
// columns x 32 / J adjacent rows a warp) fall in distinct banks.
__host__ __device__ constexpr int col_stride(int r, int j) {
  return r + (j >= 8 ? 4 : 32 / j);
}

// Floats of one plane of a pass block in shared memory: its rows, or its
// columns when each column is written as one span, rounded up to 4 so the
// next plane stays 16-byte aligned.
__host__ __device__ constexpr int pass_plane(int e, int j, int cs, bool col_out) {
  return (((rm(e - 1) + 1) > (col_out ? j * cs : 0) ? rm(e - 1) + 1 : j * cs) + 3) & ~3;
}

// One radix-P step of the block's DFTs of length R = 2^log_r, one per
// column: sub-transforms of length Ls = R / ms in, of length Ls / P out
// (Stockham, ms = 2^log_ms: P ms interleaved columns out of ms).  Butterfly
// bf = u J + jj (u = j ms + kk, column jj) reads rows u + t R / P, t < P,
// takes their DFT times exp(-2 pi i j c / Ls) (= tw[j c ms]) and writes
// output c to row (j P + c) ms + kk; a thread holds its 64 / P butterflies
// in registers between two barriers (one trip through shared memory a
// step).  Addresses: a butterfly's reads are E / P apart (a multiple of
// 256 from J = 4, so padded by a constant), and its writes ms J apart,
// which stay inside one 256-float span or step by a multiple of 256.
// col_out: write
// column jj at jj * cs + row instead (the last step of a pass whose output
// is one span per column).
template <int P>
__device__ __forceinline__ void radix_step(float* sr, float* si,
                                          const float2* __restrict__ tw, int log_r,
                                          int log_j, int log_ms, bool col_out, int cs) {
  constexpr int C = kPerThread / P;
  constexpr int LP = kLog2<P>;
  const int nthreads = blockDim.x;
  const int jmask = (1 << log_j) - 1;
  const int s_in = (1 << (log_r - LP)) << log_j;           // E / P
  const bool in_whole = (s_in & 255) == 0;
  const int in_step = rm(s_in);
  const int s_out = (1 << log_ms) << log_j;                 // ms J
  const bool whole = (s_out & 255) == 0 || s_out * P <= 256;
  const int out_step = (s_out & 255) == 0 ? rm(s_out) : s_out;
  float vr[C][P], vi[C][P];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int bf = threadIdx.x + i * nthreads;
    const int a0 = rm(bf);
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int a = in_whole ? a0 + t * in_step : rm(bf + t * s_in);
      vr[i][t] = sr[a];
      vi[i][t] = si[a];
    }
  }
  __syncthreads();                // every read is done before any write
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int bf = threadIdx.x + i * nthreads;
    const int jj = bf & jmask, u = bf >> log_j;
    const int j = u >> log_ms;
    const int q0 = ((j << LP) << log_ms) + (u & ((1 << log_ms) - 1));   // row of c = 0
    const int x0 = (q0 << log_j) + jj;
    const int a0 = col_out ? jj * cs + q0 : rm(x0);
    const int jm = j << log_ms;
    dif_stage<P, P / 2>(vr[i], vi[i]);
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const int bc = bit_reverse(c, LP);
      float yr = vr[i][bc], yi = vi[i][bc];
      if (c > 0 && j > 0) {
        const float2 w = tw[c * jm];
        const float r = w.x * yr - w.y * yi;
        yi = w.x * yi + w.y * yr;
        yr = r;
      }
      const int a = col_out ? a0 + (c << log_ms)
                  : whole   ? a0 + c * out_step
                            : rm(x0 + c * s_out);
      sr[a] = yr;
      si[a] = yi;
    }
  }
  __syncthreads();
}

// Stages s .. s + log_r - 1 of the transform (s = log_m; log_r <= 12) in
// one launch.  Before it the signal is m = 2^log_m interleaved columns of
// length L = n / m (column k at rows r m + k); group (j, k), j < L / R,
// takes the R = 2^log_r elements of rows j + t L / R of column k, idx = j m
// + k at idx + t n / R, and writes their DFT X_c times exp(-2 pi i j c / L)
// to position j m R + k + m c (column k + m c, row j, of the next layout;
// the four-step split of the column's DFT).  A block holds J adjacent
// groups (J rows of J contiguous elements in, J <= m unless m = 1): its
// loads are J-element rows n / R apart, and its stores J-element rows m
// apart, or, at m = 1 (the first pass), one contiguous span.
//
// Twiddles from sincospif on exact fractions, once per block into shared
// memory: exp(-2 pi i e / R), e < R, for the radix steps, and, where L >
// R, exp(-2 pi i j c / L) as the product of a table over c mod 64 and one
// over c / 64 for each j of the block.
template <typename T>
__global__ void __launch_bounds__(kPassElems / kPerThread)
fft_pass_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int log_n,
                int log_m, int log_r, int log_j) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int J = 1 << log_j, R = 1 << log_r, E = J << log_r;
  const int log_l = log_n - log_m;            // column length before the pass
  const bool col_out = log_m == 0;            // the output: a span per column
  const bool twiddled = log_l > log_r;        // exp(-2 pi i j c / L) applies
  const int cs = col_stride(R, J);            // column stride when col_out
  const int plane = pass_plane(E, J, cs, col_out);
  float* sr = smem;
  float* si = sr + plane;
  float2* tw = reinterpret_cast<float2*>(si + plane);   // R entries
  const int n_lo = min(64, R), n_hi = max(1, R >> 6);
  const int nj = col_out ? J : 1;             // distinct j of the block
  float2* tlo = tw + R;                       // [nj][n_lo]
  float2* thi = tlo + nj * n_lo;              // [nj][n_hi]
  const long long idx0 = static_cast<long long>(blockIdx.x) << log_j;
  const long long stride_in = 1LL << (log_n - log_r);

  // loads: element (row q, column jj) at idx0 + jj + q n / R, rows of J
  // contiguous elements; fp32 by cp.async straight into shared memory (16
  // bytes a copy from J = 4), bf16 through registers (converted to fp32)
  const bool vec = J >= 4;
  for (int e = tid * 4; vec && e < E; e += nthreads * 4) {
    const long long g = idx0 + (e & (J - 1)) + (static_cast<long long>(e >> log_j) * stride_in);
    if constexpr (sizeof(T) == 4) {
      __pipeline_memcpy_async(sr + rm(e), xr + g, 16);
      __pipeline_memcpy_async(si + rm(e), xi + g, 16);
    } else {
      const uint2 ur = *reinterpret_cast<const uint2*>(xr + g);
      const uint2 ui = *reinterpret_cast<const uint2*>(xi + g);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ur.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ur.y));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ui.x));
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ui.y));
      *reinterpret_cast<float4*>(sr + rm(e)) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(si + rm(e)) = make_float4(c.x, c.y, d.x, d.y);
    }
  }
  if (vec) {
    __pipeline_commit();
  } else {                      // J < 4 (n = 8192): element by element
    for (int e = tid; e < E; e += nthreads) {
      const long long g = idx0 + (e & (J - 1)) + (static_cast<long long>(e >> log_j) * stride_in);
      sr[rm(e)] = to_f32(xr[g]);
      si[rm(e)] = to_f32(xi[g]);
    }
  }
  // the twiddle tables, while the loads are in flight
  for (int e = tid; e < R; e += nthreads) twiddle(ldexpf(static_cast<float>(e), 1 - log_r),
                                                  &tw[e].x, &tw[e].y);
  if (twiddled) {
    for (int e = tid; e < nj * (n_lo + n_hi); e += nthreads) {
      const int jc = e / (n_lo + n_hi), c = e - jc * (n_lo + n_hi);
      const long long jg = (idx0 + jc) >> log_m;
      // j c < L: the fraction 2 j c / L is exact up to 2^24
      const long long x = c < n_lo ? jg * c : jg * 64 * (c - n_lo);
      float2* dst = c < n_lo ? &tlo[jc * n_lo + c] : &thi[jc * n_hi + c - n_lo];
      twiddle(ldexpf(static_cast<float>(x), 1 - log_l), &dst->x, &dst->y);
    }
  }
  if (vec) __pipeline_wait_prior(0);
  __syncthreads();

  // the DFTs of length R: radix-64 steps, then one of radix 2 to 32
  int log_ms = 0;
  const int n64 = log_r / 6, rest = log_r % 6;
  for (int st = 0; st < n64; ++st, log_ms += 6)
    radix_step<64>(sr, si, tw, log_r, log_j, log_ms, col_out && st == n64 - 1 && !rest, cs);
  switch (rest) {
    case 5: radix_step<32>(sr, si, tw, log_r, log_j, log_ms, col_out, cs); break;
    case 4: radix_step<16>(sr, si, tw, log_r, log_j, log_ms, col_out, cs); break;
    case 3: radix_step<8>(sr, si, tw, log_r, log_j, log_ms, col_out, cs); break;
    case 2: radix_step<4>(sr, si, tw, log_r, log_j, log_ms, col_out, cs); break;
    case 1: radix_step<2>(sr, si, tw, log_r, log_j, log_ms, col_out, cs); break;
    default: break;
  }

  // stores: X_c of column jj, times exp(-2 pi i j c / L), to j m R + k + m c
  auto twist = [&](int jc, int c, float& re, float& im) {
    if (!twiddled) return;
    const float2 a = tlo[jc * n_lo + (c & (n_lo - 1))];
    const float2 b = thi[jc * n_hi + (c >> 6)];
    const float wr = a.x * b.x - a.y * b.y, wi = a.x * b.y + a.y * b.x;
    const float r = wr * re - wi * im;
    im = wr * im + wi * re;
    re = r;
  };
  if (col_out) {                 // m = 1: column jj to [idx0 + jj] R + c
    const long long first = idx0 << log_r;
    for (int e = tid * 4; e < E; e += nthreads * 4) {
      const int jj = e >> log_r, c = e & (R - 1);
      float4 vr = *reinterpret_cast<const float4*>(sr + jj * cs + c);
      float4 vi = *reinterpret_cast<const float4*>(si + jj * cs + c);
      twist(jj, c, vr.x, vi.x);
      twist(jj, c + 1, vr.y, vi.y);
      twist(jj, c + 2, vr.z, vi.z);
      twist(jj, c + 3, vr.w, vi.w);
      *reinterpret_cast<float4*>(yr + first + e) = vr;
      *reinterpret_cast<float4*>(yi + first + e) = vi;
    }
  } else if (vec) {              // J <= m: the cluster's rows c to base + m c
    // the blocks of a cluster (2^log_cl, adjacent groups) write rows of all
    // their columns together, 2^log_cl J contiguous floats (a whole 32-byte
    // sector a plane at J = 4, 2 blocks), block `rank` the rows c = rank
    // mod 2^log_cl, reading the other block's columns through distributed
    // shared memory; a block alone writes rows of 16 bytes 16 KB apart, half
    // a sector each
    const cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int log_cl = __ffs(static_cast<int>(cluster.num_blocks())) - 1;
    const int log_chunks = log_cl + log_j - 2;   // float4 chunks of a cluster row
    const long long m = 1LL << log_m;
    const long long idx0_cl = idx0 - (static_cast<long long>(rank) << log_j);
    const long long base = ((idx0_cl >> log_m) << (log_m + log_r)) + (idx0_cl & (m - 1));
    cluster.sync();              // every block's transform is done
    for (int e4 = tid; e4 < (E >> 2); e4 += nthreads) {
      const int chunk = e4 & ((1 << log_chunks) - 1);
      const int c = rank + ((e4 >> log_chunks) << log_cl);
      const int owner = chunk >> (log_j - 2);
      const int a = rm((c << log_j) + ((chunk << 2) & (J - 1)));
      float4 vr = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sr, owner) + a);
      float4 vi = *reinterpret_cast<const float4*>(cluster.map_shared_rank(si, owner) + a);
      twist(0, c, vr.x, vi.x);
      twist(0, c, vr.y, vi.y);
      twist(0, c, vr.z, vi.z);
      twist(0, c, vr.w, vi.w);
      const long long g = base + c * m + (chunk << 2);
      *reinterpret_cast<float4*>(yr + g) = vr;
      *reinterpret_cast<float4*>(yi + g) = vi;
    }
    cluster.sync();              // no block leaves while its columns are read
  } else {                       // J < 4 (n = 8192): element by element
    const long long m = 1LL << log_m;
    const long long base = ((idx0 >> log_m) << (log_m + log_r)) + (idx0 & (m - 1));
    for (int e = tid; e < E; e += nthreads) {
      const int c = e >> log_j, jj = e & (J - 1);
      float vr = sr[rm(e)], vi = si[rm(e)];
      twist(0, c, vr, vi);
      yr[base + c * m + jj] = vr;
      yi[base + c * m + jj] = vi;
    }
  }
}

// Every stage of an n = 2^log_n <= 4096 transform in one block, in shared
// memory: stage u (l = n >> (u+1), mm = 2^u) takes butterfly b = j mm + kk
// from b and b + n / 2 and writes top = j 2 mm + kk and bot = top + mm,
// with exp(-i pi j / l) = table[j 2^u].
template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_local_kernel(const T* __restrict__ xr, const T* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, int log_n) {
  extern __shared__ float smem[];
  const int n = 1 << log_n;
  const int half = n / 2;
  float* sr = smem;
  float* si = smem + n;
  float* twr = si + n;            // exp(-2 pi i k / n), k < n / 2
  float* twi = twr + half;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    sr[e] = to_f32(xr[e]);
    si[e] = to_f32(xi[e]);
  }
  const float step = 2.0f / static_cast<float>(n);
  for (int k = threadIdx.x; k < half; k += kThreads)
    twiddle(static_cast<float>(k) * step, &twr[k], &twi[k]);
  __syncthreads();
  for (int u = 0; u < log_n; ++u) {
    float o[4][kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = threadIdx.x + q * kThreads;
      if (b < half) {
        const int t = (b >> u) << u;
        const float wr = twr[t], wi = twi[t];
        const float ar = sr[b], ai = si[b], br = sr[b + half], bi = si[b + half];
        const float dr = ar - br, di = ai - bi;
        o[0][q] = ar + br;
        o[1][q] = ai + bi;
        o[2][q] = wr * dr - wi * di;
        o[3][q] = wr * di + wi * dr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int b = threadIdx.x + q * kThreads;
      if (b < half) {
        const int top = ((b >> u) << (u + 1)) + (b & ((1 << u) - 1));
        const int bot = top + (1 << u);
        sr[top] = o[0][q];
        si[top] = o[1][q];
        sr[bot] = o[2][q];
        si[bot] = o[3][q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    yr[e] = sr[e];
    yi[e] = si[e];
  }
}

// The blocks' columns J of a pass of 2^log_r stages from stage log_m: as
// many as kPassElems holds, no more than the n / R groups, and (past the
// first pass) no more than the m adjacent columns of one row.
int pass_log_j(int log_n, int log_m, int log_r) {
  int log_j = 0;
  while (((1 << (log_j + 1)) << log_r) <= kPassElems && log_j + 1 + log_r <= log_n &&
         (log_m == 0 || log_j + 1 <= log_m))
    ++log_j;
  return log_j;
}

template <typename T>
cudaError_t launch_pass(const void* xr, const void* xi, void* yr, void* yi,
                        int log_n, int log_m, int log_r, cudaStream_t s) {
  const int log_j = pass_log_j(log_n, log_m, log_r);
  const int J = 1 << log_j, R = 1 << log_r, E = J << log_r;
  if (E % kPerThread != 0 || (log_m > 0 && J > (1 << log_m)))
    return cudaErrorInvalidValue;
  const bool col_out = log_m == 0;
  const int cs = col_stride(R, J);
  const int plane = pass_plane(E, J, cs, col_out);
  const int n_lo = std::min(64, R), n_hi = std::max(1, R >> 6);
  const size_t smem = 2 * plane * sizeof(float) + R * sizeof(float2) +
                      (col_out ? J : 1) * (n_lo + n_hi) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      fft_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // past the first pass (J >= 4), pairs of adjacent blocks write their
  // rows together, each block half of the R rows, both groups in one row
  // of m; 4 or 8 blocks moved more of the data between SMs than they
  // saved (PERF.md section 6)
  const long long blocks = (1LL << log_n) / E;
  const int cl = log_m > 0 && J >= 4 && blocks % 2 == 0 && 2 * J <= (1 << log_m) ? 2 : 1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(E / kPerThread);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fft_pass_kernel<T>, static_cast<const T*>(xr),
                            static_cast<const T*>(xi), static_cast<float*>(yr),
                            static_cast<float*>(yi), log_n, log_m, log_r, log_j);
}

template <typename T>
cudaError_t local(const void* xr, const void* xi, void* yr, void* yi, int log_n,
                  cudaStream_t s) {
  // both planes and the two halves of the twiddle table: 48 KB at 4096, the
  // default limit
  const size_t smem = (3 << log_n) * sizeof(float);
  fft_local_kernel<T><<<1, kThreads, smem, s>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi),
      static_cast<float*>(yr), static_cast<float*>(yi), log_n);
  return cudaGetLastError();
}

bool valid_n(long long n) { return n >= 2 && (n & (n - 1)) == 0; }

}  // namespace

// One pass of q (1..12) stages from stage log_m through device memory, n =
// 2^log_n > 4096.  dtype (x): 0 = float32, 1 = bfloat16; y is float32; x
// and y are two planes of n elements each, contiguous, and must not
// overlap.  Returns the CUDA error of the launch (0 on success); the Python
// wrapper raises on anything else.
extern "C" int repro_fft_pass(int dtype, int q, const void* xr, const void* xi,
                              void* yr, void* yi, long long n, int log_m,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_n = 0;
  while (log_n < 62 && (1LL << log_n) < n) ++log_n;
  if (!valid_n(n) || n <= kLocalMax || log_n > 31 || q < 1 || q > kMaxLogR ||
      log_m < 0 || log_m + q > log_n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch_pass<float>(xr, xi, yr, yi, log_n, log_m, q, s));
    case 1:
      return static_cast<int>(launch_pass<__nv_bfloat16>(xr, xi, yr, yi, log_n, log_m, q, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Every stage of an n = 2^log_n transform, 1 <= log_n <= 12, in one block;
// may run in place (x == y).
extern "C" int repro_fft_local(int dtype, const void* xr, const void* xi,
                               void* yr, void* yi, int log_n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n < 1 || (1 << log_n) > kLocalMax)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(local<float>(xr, xi, yr, yi, log_n, s));
    case 1: return static_cast<int>(local<__nv_bfloat16>(xr, xi, yr, yi, log_n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
