// Mamba2 SSD (state-space dual) chunked scan, written for Hopper (sm_90a).
//
// Replaces ssd_pallas (src/repro/kernels/ssd_scan.py:153, kernel body
// _ssd_kernel at lines 124-150) together with its wrapper's d_skip / h0
// handling (src/repro/kernels/ops.py:144-154).  Per head h, with
// A = -exp(a_log[h]) and head h reading group g = h / (H / G):
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (outer) B_t,   y_t = C_t . h_t
//                                                        + d_skip[h] x_t
//
// x (B, S, H, P) and B / C (B, S, G, N) in bf16 or fp32, dt (B, S, H) fp32
// (already softplus'd), a_log / d_skip (H,) fp32, h0 / h_out (B, H, P, N)
// fp32, y (B, S, H, P) in x's dtype.  The sequence is cut into chunks of
// q = min(64, S) positions (S % q == 0; the wrapper checks).  Per chunk, as
// _chunk_body computes it: s = inclusive cumsum of dt A,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(s_i - s_j) dt_j x_j
//           + exp(s_i) C_i . h_in                     (carried state)
//   h_out = exp(s_last) h_in + sum_j exp(s_last - s_j) dt_j x_j (outer) B_j
// d_skip x is added in fp32 before the single rounding of y, as ssd_xla
// does (the Pallas wrapper rounds twice); h0 (or zeros) seeds the state.
//
// What bounds it on the H100: bytes.  At the hybrid prefill's longest
// prompt (B = 1, S = 960, H = 64, P = N = 64, G = 1, bf16) it moves ~17 MB
// (x and y 7.9 MB each, dt, B, C, the final state), 5.2 us at 3.35 TB/s,
// against ~2.0 GFLOP (2.0 us at the bf16 tensor-core peak).  Two routes,
// picked by dtype (ssd_scan.route):
//
// bf16, the served dtype ("mma"): chunk-parallel on the tensor cores, the
// SSD algorithm of Dao & Gu ("Transformers are SSMs", arXiv:2405.21060) in
// three launches from one C entry:
//   1. chunk states, grid (chunks, H x P-slices, B): warp 0 scans dt A
//      over the chunk; dh_c = sum_j x_j (outer) (exp(s_last - s_j) dt_j B_j)
//      goes to an fp32 workspace (B, chunks, H, P, N), exp(s_last) beside
//      it;
//   2. the state pass, one thread per (b, h, state entry), sequential over
//      the chunks: h_c = exp(s_last,c) h_{c-1} + dh_c, written in place, so
//      the workspace then holds the state entering each chunk (h0 or zeros
//      first) and the last state is h_out;
//   3. chunk outputs, grid (chunks, H x P-slices, B): C B^T on the tensor
//      cores, then the decay exp(s_i - s_j), dt_j and the causal mask folded
//      into each score in fp32; y = scores . x + exp(s_i) C . h_entering +
//      d_skip x, summed in fp32 before the one rounding of y, staged in
//      shared memory and stored 16 bytes a thread.
// One chunk (S <= 64) takes one launch that does 1 and 3 and writes h_out.
// Every product is mma.sync m16n8k16 with fp32 sums (csrc/mma_sync.cuh);
// x, B and C are exact bf16 operands.  The scores, exp(s_last - s_j) dt_j
// B_j and the entering state are fp32: each is split as hi = bf16(v),
// lo = bf16(v - hi), and both halves are multiplied against the exact
// operand (7 products a chunk; ~2^-17 relative where one bf16 rounding
// would give 2^-9, which the final state's 1e-4 tolerance does not take).
// Operands sit in shared memory in rows padded by 16 bytes (ldmatrix without
// bank conflicts), q, N and the P-slice padded with zeros to multiples of
// 16.  A block takes P in slices of 64 columns (P rounded up to 16 if
// less): narrower slices give the same bits and, on an H100, no shorter
// calls at zamba2's widths.  No atomics: a
// row's bits depend on its own inputs only, and reruns are bit-identical.
// What holds it (PERF.md section 7): 12x its bound at S = 960; the
// workspace goes through device memory three times (~47 of ~80 MB moved),
// and the output kernel's 74 KB of shared memory keep 3 blocks an SM.
//
// fp32 ("simt"): the first port's kernel, unchanged.  The TPU's sequential
// chunk axis is a loop inside one thread block, the fp32 state in shared
// memory across it; a block takes 16 state rows (of P): grid (P / 16, H,
// B).  Per chunk, after one load of x, dt, B and C into shared memory,
// warp 0 scans dt A, then one thread per (i, j) score, one per (i, p)
// output, one per (p, n) state entry, fp32 FMAs on the CUDA cores.
//
// The cumsum is a Kogge-Stone scan, not jnp.cumsum's order: exp(s_i - s_j)
// therefore differs from the reference by a few fp32 ulps of |s|; the tests
// hold fp32 y and states to 1e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSliceP = 16;     // state rows (of P) a thread block (simt)
constexpr int kMaxChunk = 64;   // positions a chunk (warp 0 scans 2 x 32)
constexpr int kMaxState = 256;  // N
constexpr unsigned kFull = 0xffffffffu;

// Floats of dynamic shared memory for a chunk of q positions and state N
// (mirrored by ssd_scan.smem_bytes in Python).
__host__ __device__ constexpr size_t smem_floats(int q, int n) {
  return 2 * static_cast<size_t>(q) * (n + 1)      // B, C chunk (padded rows)
         + static_cast<size_t>(q) * (q + 1)        // scores
         + 2 * static_cast<size_t>(q) * kSliceP    // x, dt x
         + static_cast<size_t>(kSliceP) * (n + 1)  // state slice
         + 3 * static_cast<size_t>(q);             // dt, cumsum, exit decays
}

// Grid: (ceil(P / 16), H, B).  Block (ps, h, b) owns state rows
// p0 = 16 ps .. p0 + 15 of head h, batch b.
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ h0,
                const float* __restrict__ d_skip, float* __restrict__ y,
                float* __restrict__ h_out, int seqlen, int nheads, int p_dim,
                int ngroups, int n_dim, int q) {
  extern __shared__ float smem[];
  const int ld = n_dim + 1;
  float* bs = smem;                    // (q, ld)
  float* cs = bs + q * ld;             // (q, ld)
  float* sc = cs + q * ld;             // (q, q + 1) masked scores
  float* xs = sc + q * (q + 1);        // (q, 16) x of the slice
  float* dtx = xs + q * kSliceP;       // (q, 16) dt x
  float* hs = dtx + q * kSliceP;       // (16, ld) the carried state
  float* dts = hs + kSliceP * ld;      // (q,)
  float* scum = dts + q;               // (q,) inclusive cumsum of dt A
  float* wdec = scum + q;              // (q,) exp(s_last - s_j)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kSliceP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (nheads / ngroups);
  const int np = min(kSliceP, p_dim - p0);   // rows of this slice
  const float a = -expf(a_log[h]);
  const size_t state0 = (static_cast<size_t>(b) * nheads + h) * p_dim + p0;

  for (int e = tid; e < kSliceP * n_dim; e += kThreads) {
    const int pp = e / n_dim, n = e % n_dim;
    hs[pp * ld + n] =
        (h0 != nullptr && pp < np) ? h0[(state0 + pp) * n_dim + n] : 0.f;
  }

  for (int t0 = 0; t0 < seqlen; t0 += q) {
    const size_t row0 = static_cast<size_t>(b) * seqlen + t0;  // (b, t0)
    for (int j = tid; j < q; j += kThreads) dts[j] = dt[(row0 + j) * nheads + h];
    for (int e = tid; e < q * n_dim; e += kThreads) {
      const int j = e / n_dim, n = e % n_dim;
      const size_t src = ((row0 + j) * ngroups + g) * n_dim + n;
      bs[j * ld + n] = bm[src];
      cs[j * ld + n] = cm[src];
    }
    for (int e = tid; e < q * kSliceP; e += kThreads) {
      const int j = e / kSliceP, pp = e % kSliceP;
      xs[e] = pp < np ? x[((row0 + j) * nheads + h) * p_dim + p0 + pp] : 0.f;
    }
    __syncthreads();  // the state seed, dts, bs, cs and xs are in

    if (tid < 32) {   // warp 0: inclusive scan of dt A over 2 x 32 lanes
      float v0 = tid < q ? dts[tid] * a : 0.f;
      float v1 = tid + 32 < q ? dts[tid + 32] * a : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(kFull, v0, o);
        const float u1 = __shfl_up_sync(kFull, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(kFull, v0, 31);
      if (tid < q) scum[tid] = v0;
      if (tid + 32 < q) scum[tid + 32] = v1;
      __syncwarp();
      const float last = scum[q - 1];
      if (tid < q) wdec[tid] = expf(last - v0);
      if (tid + 32 < q) wdec[tid + 32] = expf(last - v1);
    }
    for (int e = tid; e < q * kSliceP; e += kThreads)
      dtx[e] = dts[e / kSliceP] * xs[e];
    __syncthreads();  // scum, wdec and dtx are in

    // scores[i][j] = (C_i . B_j) exp(s_i - s_j) for j <= i, else 0
    for (int e = tid; e < q * q; e += kThreads) {
      const int i = e / q, j = e % q;
      float v = 0.f;
      if (j <= i) {
        const float* ci = cs + i * ld;
        const float* bj = bs + j * ld;
        float dot = 0.f;
        for (int n = 0; n < n_dim; ++n) dot += ci[n] * bj[n];
        v = dot * expf(scum[i] - scum[j]);
      }
      sc[i * (q + 1) + j] = v;
    }
    __syncthreads();  // scores are in

    // y_i = scores_i . dtx + exp(s_i) C_i . h_in (+ d_skip x_i)
    for (int e = tid; e < q * kSliceP; e += kThreads) {
      const int i = e / kSliceP, pp = e % kSliceP;
      if (pp >= np) continue;
      const float* si = sc + i * (q + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += si[j] * dtx[j * kSliceP + pp];
      const float* ci = cs + i * ld;
      const float* hp = hs + pp * ld;
      float carry = 0.f;
      for (int n = 0; n < n_dim; ++n) carry += ci[n] * hp[n];
      float v = acc + expf(scum[i]) * carry;
      if (d_skip != nullptr) v += d_skip[h] * xs[e];
      y[((row0 + i) * nheads + h) * p_dim + p0 + pp] = v;
    }
    __syncthreads();  // h_in has been read: the update may overwrite it

    // h_out = exp(s_last) h_in + sum_j (exp(s_last - s_j) dt_j x_j) B_j
    const float dlast = expf(scum[q - 1]);
    for (int e = tid; e < kSliceP * n_dim; e += kThreads) {
      const int pp = e / n_dim, n = e % n_dim;
      float acc = 0.f;
      for (int j = 0; j < q; ++j)
        acc += (wdec[j] * dtx[j * kSliceP + pp]) * bs[j * ld + n];
      hs[pp * ld + n] = dlast * hs[pp * ld + n] + acc;
    }
    __syncthreads();  // the next chunk's loads overwrite bs, dts, ...
  }

  for (int e = tid; e < np * n_dim; e += kThreads) {
    const int pp = e / n_dim, n = e % n_dim;
    h_out[(state0 + pp) * n_dim + n] = hs[pp * ld + n];
  }
}

cudaError_t launch_simt(const void* x, const void* dt, const void* a_log,
                        const void* bm, const void* cm, const void* h0,
                        const void* d_skip, void* y, void* h_out, int batch,
                        int seqlen, int nheads, int p_dim, int ngroups,
                        int n_dim, int q, void* stream) {
  if (batch == 0 || seqlen == 0 || nheads == 0 || p_dim == 0) return cudaSuccess;
  if (q <= 0 || q > kMaxChunk || seqlen % q || ngroups <= 0 ||
      nheads % ngroups || n_dim <= 0 || n_dim > kMaxState)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(q, n_dim) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p_dim + kSliceP - 1) / kSliceP, nheads, batch);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(h0),
      static_cast<const float*>(d_skip), static_cast<float*>(y),
      static_cast<float*>(h_out), seqlen, nheads, p_dim, ngroups, n_dim, q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel on the tensor cores.
// ---------------------------------------------------------------------------

using tc::bf16;
constexpr int kTcThreads = 256;  // 8 warps a block
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kPad = 8;        // bf16 elements padding each shared row
constexpr int kPassThreads = 256;
constexpr int kPassUnroll = 4;   // chunks whose loads the state pass issues at once
constexpr int kStateBatch = 8;   // 16-byte state loads a thread issues at once

enum Mode { kStates = 0, kOutputs = 1, kFused = 2 };

struct Dims {
  int seqlen, nheads, p_dim, ngroups, n_dim, q, nc, ps;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

__host__ __device__ inline unsigned take(unsigned& at, unsigned bytes) {
  const unsigned here = at;
  at += (bytes + 15u) & ~15u;
  return here;
}

// Byte offsets of one block's shared arrays: C, B (qp x ldn), x and the y
// staging tile (qp x ldp), the split scores (qp x ldq each), r_hi / r_lo
// (the entering state's split rows of P, or the split w_j B_j rows of the
// chunk; rrows x ldn each) and four fp32 vectors of 64 (dt, s, exp(s), w).
struct Smem {
  int qp, np, ldn, ldp, ldq;
  unsigned c, b, x, y, shi, slo, rhi, rlo, f, bytes;
};

__host__ __device__ inline Smem smem_layout(int mode, int q, int n_dim, int ps) {
  Smem s;
  s.qp = round16(q);
  s.np = round16(n_dim);
  s.ldn = s.np + kPad;
  s.ldp = ps + kPad;
  s.ldq = s.qp + kPad;
  const bool out = mode != kStates;
  const int rrows = mode == kStates    ? s.qp
                    : mode == kOutputs ? ps
                    : s.qp > ps        ? s.qp
                                       : ps;
  unsigned at = 0;
  s.c = out ? take(at, 2u * s.qp * s.ldn) : 0;
  s.b = take(at, 2u * s.qp * s.ldn);
  s.x = take(at, 2u * s.qp * s.ldp);
  s.y = out ? take(at, 2u * s.qp * s.ldp) : 0;
  s.shi = out ? take(at, 2u * s.qp * s.ldq) : 0;
  s.slo = out ? take(at, 2u * s.qp * s.ldq) : 0;
  s.rhi = take(at, 2u * rrows * s.ldn);
  s.rlo = take(at, 2u * rrows * s.ldn);
  s.f = take(at, 4u * 4 * kMaxChunk);
  s.bytes = at;
  return s;
}

// rows x cols bf16 of global memory (row stride ld_src) into a shared tile
// of prows x pcols (row stride ld), zeros past rows / cols.  vec: cols and
// ld_src are multiples of 8 and src is 16-byte aligned; the copies are then
// cp.async, 16 bytes each, in flight until cp_async_wait_all.
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* src,
                                          size_t ld_src, int rows, int cols,
                                          int prows, int pcols, bool vec) {
  if (vec) {
    const int per_row = pcols / 8;
    for (int e = threadIdx.x; e < prows * per_row; e += kTcThreads) {
      const int r = e / per_row, c = (e % per_row) * 8;
      const bool in = r < rows && c < cols;
      tc::cp_async16(tc::smem_u32(dst + r * ld + c), in ? src + r * ld_src + c : src,
                     in);
    }
  } else {
    for (int e = threadIdx.x; e < prows * pcols; e += kTcThreads) {
      const int r = e / pcols, c = e % pcols;
      dst[r * ld + c] = (r < rows && c < cols) ? src[r * ld_src + c]
                                               : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = hi + lo, hi = bf16(v), lo = bf16(v - hi) (v - hi is exact in fp32)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tc::pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// rows p0 .. p0 + rows of a (P, N) fp32 state into r_hi / r_lo, split, as
// rows x np (zeros past N and past rows).  vec4: N % 4 == 0 and the state
// 16-byte aligned; each thread then has kStateBatch 16-byte loads in flight
// before it splits any.
__device__ __forceinline__ void load_state(bf16* r_hi, bf16* r_lo, int ld,
                                           const float* src, int n_dim,
                                           int rows, int prows, int np,
                                           bool vec4) {
  if (vec4) {
    const int per_row = np / 4, total = prows * per_row;
    for (int base = threadIdx.x; base < total; base += kTcThreads * kStateBatch) {
      float4 v[kStateBatch];
#pragma unroll
      for (int k = 0; k < kStateBatch; ++k) {
        const int e = base + k * kTcThreads, r = e / per_row, n = (e % per_row) * 4;
        v[k] = e < total && r < rows && n < n_dim
                   ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * n_dim + n)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kStateBatch; ++k) {
        const int e = base + k * kTcThreads, r = e / per_row, n = (e % per_row) * 4;
        if (e >= total) break;
        uint32_t hi[2], lo[2];
        split2(v[k].x, v[k].y, hi[0], lo[0]);
        split2(v[k].z, v[k].w, hi[1], lo[1]);
        *reinterpret_cast<uint2*>(r_hi + r * ld + n) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(r_lo + r * ld + n) = make_uint2(lo[0], lo[1]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < prows * (np / 2); e += kTcThreads) {
      const int r = e / (np / 2), n = (e % (np / 2)) * 2;
      const float* row = src + static_cast<size_t>(r) * n_dim + n;
      uint32_t hi, lo;
      split2(r < rows && n < n_dim ? row[0] : 0.f,
             r < rows && n + 1 < n_dim ? row[1] : 0.f, hi, lo);
      *reinterpret_cast<uint32_t*>(r_hi + r * ld + n) = hi;
      *reinterpret_cast<uint32_t*>(r_lo + r * ld + n) = lo;
    }
  }
}

// A fragment (16 x 16, row-major tile at rows m0, cols k0)
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* t, int ld,
                                       int m0, int k0, int lane) {
  tc::ldsm_x4(r, tc::smem_u32(t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8));
}

// A fragment of the transpose of a tile stored [k][m]
__device__ __forceinline__ void frag_a_trans(uint32_t (&r)[4], const bf16* t,
                                             int ld, int m0, int k0, int lane) {
  tc::ldsm_x4_trans(r, tc::smem_u32(t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                                    m0 + ((lane >> 3) & 1) * 8));
}

// B fragments of two n8 tiles (cols n0 .. n0 + 15) from a tile stored
// [n][k]: r[0], r[1] the first, r[2], r[3] the second
__device__ __forceinline__ void frag_b(uint32_t (&r)[4], const bf16* t, int ld,
                                       int n0, int k0, int lane) {
  tc::ldsm_x4(r, tc::smem_u32(t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                              k0 + ((lane >> 3) & 1) * 8));
}

// the same from a tile stored [k][n]
__device__ __forceinline__ void frag_b_trans(uint32_t (&r)[4], const bf16* t,
                                             int ld, int n0, int k0, int lane) {
  tc::ldsm_x4_trans(r, tc::smem_u32(t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                                    n0 + (lane >> 4) * 8));
}

__device__ __forceinline__ void mma2(float (&d)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  tc::mma16816(d[0], a, b[0], b[1]);
  tc::mma16816(d[1], a, b[2], b[3]);
}

// Grid: (chunks, H x P-slices, B).  kStates: dh of the chunk into the
// workspace and exp(s_last) into dec; kOutputs: y of the chunk from the
// state entering it (the workspace after the state pass); kFused (one
// chunk): y from h0 and h_out = exp(s_last) h0 + dh.
template <int kMode>
__global__ void __launch_bounds__(kTcThreads)
ssd_scan_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                      const float* __restrict__ h0,
                      const float* __restrict__ d_skip, bf16* __restrict__ y,
                      float* __restrict__ ws, float* __restrict__ dec,
                      float* __restrict__ h_out, Dims d, bool vec,
                      bool vec4) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const Smem L = smem_layout(kMode, d.q, d.n_dim, d.ps);
  bf16* c_s = reinterpret_cast<bf16*>(smem + L.c);
  bf16* b_s = reinterpret_cast<bf16*>(smem + L.b);
  bf16* x_s = reinterpret_cast<bf16*>(smem + L.x);
  bf16* y_s = reinterpret_cast<bf16*>(smem + L.y);
  bf16* s_hi = reinterpret_cast<bf16*>(smem + L.shi);
  bf16* s_lo = reinterpret_cast<bf16*>(smem + L.slo);
  bf16* r_hi = reinterpret_cast<bf16*>(smem + L.rhi);
  bf16* r_lo = reinterpret_cast<bf16*>(smem + L.rlo);
  float* dt_s = reinterpret_cast<float*>(smem + L.f);
  float* s_s = dt_s + kMaxChunk;     // inclusive cumsum of dt A
  float* e_s = s_s + kMaxChunk;      // exp(s_i)
  float* w_s = e_s + kMaxChunk;      // exp(s_last - s_j) dt_j

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, quad = lane & 3;   // fragment row, column pair
  const int c = blockIdx.x;
  const int nps = (d.p_dim + d.ps - 1) / d.ps;
  const int h = blockIdx.y / nps, p0 = (blockIdx.y % nps) * d.ps;
  const int b = blockIdx.z;
  const int g = h / (d.nheads / d.ngroups);
  const int q = d.q, qp = L.qp, pn = d.p_dim * d.n_dim;
  const int pw = min(d.ps, d.p_dim - p0);       // columns of P this block owns
  const size_t row0 = static_cast<size_t>(b) * d.seqlen + static_cast<size_t>(c) * q;
  const size_t slot = (static_cast<size_t>(b) * d.nc + c) * d.nheads + h;
  // the state entering the chunk: the workspace after the state pass, or
  // h0; none (zeros) for the first chunk without h0
  const float* h_in =
      kMode == kOutputs ? (c > 0 || h0 != nullptr ? ws + slot * pn : nullptr)
      : kMode == kFused && h0 != nullptr ? h0 + (static_cast<size_t>(b) * d.nheads + h) * pn
                                         : nullptr;

  copy_tile(b_s, L.ldn, bm + (row0 * d.ngroups + g) * d.n_dim,
            static_cast<size_t>(d.ngroups) * d.n_dim, q, d.n_dim, qp, L.np, vec);
  if (kMode != kStates)
    copy_tile(c_s, L.ldn, cm + (row0 * d.ngroups + g) * d.n_dim,
              static_cast<size_t>(d.ngroups) * d.n_dim, q, d.n_dim, qp, L.np, vec);
  copy_tile(x_s, L.ldp, x + (row0 * d.nheads + h) * d.p_dim + p0,
            static_cast<size_t>(d.nheads) * d.p_dim, q, pw, qp, d.ps, vec);
  if (tid < kMaxChunk) dt_s[tid] = tid < q ? dt[(row0 + tid) * d.nheads + h] : 0.f;
  if (h_in != nullptr)        // rows p0 .. p0 + ps of the state, split
    load_state(r_hi, r_lo, L.ldn, h_in + static_cast<size_t>(p0) * d.n_dim,
               d.n_dim, pw, d.ps, L.np, vec4);
  __syncthreads();  // dt is in; the tiles' copies may still be in flight

  if (warp == 0) {  // inclusive scan of dt A over 2 x 32 lanes
    const float a = -expf(a_log[h]);
    float v0 = lane < q ? dt_s[lane] * a : 0.f;
    float v1 = lane + 32 < q ? dt_s[lane + 32] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u0 = __shfl_up_sync(kFull, v0, o);
      const float u1 = __shfl_up_sync(kFull, v1, o);
      if (lane >= o) {
        v0 += u0;
        v1 += u1;
      }
    }
    v1 += __shfl_sync(kFull, v0, 31);
    const float last = __shfl_sync(kFull, q - 1 < 32 ? v0 : v1, (q - 1) & 31);
    s_s[lane] = v0;
    s_s[lane + 32] = v1;
    e_s[lane] = expf(v0);
    e_s[lane + 32] = expf(v1);
    w_s[lane] = lane < q ? expf(last - v0) * dt_s[lane] : 0.f;
    w_s[lane + 32] = lane + 32 < q ? expf(last - v1) * dt_s[lane + 32] : 0.f;
    if (kMode == kStates && p0 == 0 && lane == 0) dec[slot] = expf(last);
  }
  cp_async_wait_all();
  __syncthreads();  // the tiles, s, exp(s) and w are in

  const int mt_n = qp / 16, pt_n = d.ps / 16, nt_n = L.np / 16;
  if (kMode != kStates) {
    // scores (i, j) = (C_i . B_j) exp(s_i - s_j) dt_j for j <= i < q, split
    for (int it = warp; it < mt_n * mt_n; it += kTcWarps) {
      const int mt = it / mt_n, jt = it % mt_n;
      if (jt > mt) continue;             // above the diagonal: never read
      float acc[2][4] = {};
      for (int kn = 0; kn < nt_n; ++kn) {
        uint32_t af[4], bf[4];
        frag_a(af, c_s, L.ldn, mt * 16, kn * 16, lane);
        frag_b(bf, b_s, L.ldn, jt * 16, kn * 16, lane);
        mma2(acc, af, bf);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = mt * 16 + gid + rr * 8;
          const int j = jt * 16 + hf * 8 + quad * 2;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (j + e <= i && i < q)
                       ? acc[hf][rr * 2 + e] * expf(s_s[i] - s_s[j + e]) * dt_s[j + e]
                       : 0.f;
          uint32_t hi, lo;
          split2(v[0], v[1], hi, lo);
          *reinterpret_cast<uint32_t*>(s_hi + i * L.ldq + j) = hi;
          *reinterpret_cast<uint32_t*>(s_lo + i * L.ldq + j) = lo;
        }
    }
    __syncthreads();  // the scores are in

    // y (i, p) = scores_i . x_p + exp(s_i) C_i . h_in_p (+ d_skip x_ip)
    const float dsk = d_skip != nullptr ? d_skip[h] : 0.f;
    for (int it = warp; it < mt_n * pt_n; it += kTcWarps) {
      const int mt = it / pt_n, pt = it % pt_n;
      float o[2][4] = {}, hc[2][4] = {};
      for (int kk = 0; kk <= mt; ++kk) {
        uint32_t ah[4], al[4], bx[4];
        frag_a(ah, s_hi, L.ldq, mt * 16, kk * 16, lane);
        frag_a(al, s_lo, L.ldq, mt * 16, kk * 16, lane);
        frag_b_trans(bx, x_s, L.ldp, pt * 16, kk * 16, lane);
        mma2(o, ah, bx);
        mma2(o, al, bx);
      }
      if (h_in != nullptr) {
        for (int kn = 0; kn < nt_n; ++kn) {
          uint32_t ac[4], bh[4], bl[4];
          frag_a(ac, c_s, L.ldn, mt * 16, kn * 16, lane);
          frag_b(bh, r_hi, L.ldn, pt * 16, kn * 16, lane);
          frag_b(bl, r_lo, L.ldn, pt * 16, kn * 16, lane);
          mma2(hc, ac, bh);
          mma2(hc, ac, bl);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = mt * 16 + gid + rr * 8;
          const int p = pt * 16 + hf * 8 + quad * 2;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = o[hf][rr * 2 + e] + e_s[i] * hc[hf][rr * 2 + e];
            if (d_skip != nullptr)
              v[e] += dsk * __bfloat162float(x_s[i * L.ldp + p + e]);
          }
          *reinterpret_cast<uint32_t*>(y_s + i * L.ldp + p) = tc::pack_bf16(v[0], v[1]);
        }
    }
    __syncthreads();  // y is staged; r_hi / r_lo are free
    bf16* dst = y + (row0 * d.nheads + h) * d.p_dim + p0;
    const size_t ld_dst = static_cast<size_t>(d.nheads) * d.p_dim;
    if (vec) {
      const int per_row = d.ps / 8;
      for (int e = tid; e < q * per_row; e += kTcThreads) {
        const int r = e / per_row, cc = (e % per_row) * 8;
        if (cc < pw)
          *reinterpret_cast<int4*>(dst + r * ld_dst + cc) =
              *reinterpret_cast<const int4*>(y_s + r * L.ldp + cc);
      }
    } else {
      for (int e = tid; e < q * pw; e += kTcThreads)
        dst[(e / pw) * ld_dst + e % pw] = y_s[(e / pw) * L.ldp + e % pw];
    }
  }

  if (kMode != kOutputs) {
    // w_j B_j, split, rows j of the chunk (zeros past q: w is 0 there)
    for (int e = tid; e < qp * (L.np / 2); e += kTcThreads) {
      const int j = e / (L.np / 2), n = (e % (L.np / 2)) * 2;
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b_s + j * L.ldn + n);
      uint32_t hi, lo;
      split2(w_s[j] * __low2float(bb), w_s[j] * __high2float(bb), hi, lo);
      *reinterpret_cast<uint32_t*>(r_hi + j * L.ldn + n) = hi;
      *reinterpret_cast<uint32_t*>(r_lo + j * L.ldn + n) = lo;
    }
    __syncthreads();  // w B is in

    // dh (p, n) = sum_j x_jp (w_j B_jn)
    const float elast = e_s[q - 1];
    for (int it = warp; it < pt_n * nt_n; it += kTcWarps) {
      const int pt = it / nt_n, nt = it % nt_n;
      float acc[2][4] = {};
      for (int kk = 0; kk < mt_n; ++kk) {
        uint32_t ax[4], bh[4], bl[4];
        frag_a_trans(ax, x_s, L.ldp, pt * 16, kk * 16, lane);
        frag_b_trans(bh, r_hi, L.ldn, nt * 16, kk * 16, lane);
        frag_b_trans(bl, r_lo, L.ldn, nt * 16, kk * 16, lane);
        mma2(acc, ax, bh);
        mma2(acc, ax, bl);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int pl = pt * 16 + gid + rr * 8;
          if (pl >= pw) continue;
          const size_t row = static_cast<size_t>(p0 + pl) * d.n_dim;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nt * 16 + hf * 8 + quad * 2 + e;
            if (n >= d.n_dim) continue;
            const float v = acc[hf][rr * 2 + e];
            if (kMode == kStates) {
              ws[slot * pn + row + n] = v;
            } else {
              const size_t at = (static_cast<size_t>(b) * d.nheads + h) * pn + row + n;
              h_out[at] = h0 != nullptr ? elast * h0[at] + v : v;
            }
          }
        }
    }
  }
}

// One thread per (state entry, h, b): h_c = exp(s_last,c) h_{c-1} + dh_c
// over the chunks, each chunk's dh replaced in place by the state entering
// it; the last state is h_out.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_state_pass(float* ws, const float* __restrict__ dec,
                    const float* __restrict__ h0, float* __restrict__ h_out,
                    int nc, int nheads, int pn) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * nheads + h;
  const size_t stride = static_cast<size_t>(nheads) * pn;   // one chunk
  float* w = ws + (static_cast<size_t>(b) * nc * nheads + h) * pn + e;
  const float* dc = dec + static_cast<size_t>(b) * nc * nheads + h;
  float st = h0 != nullptr ? h0[bh * pn + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassUnroll) {
    float dh[kPassUnroll], de[kPassUnroll];
#pragma unroll
    for (int k = 0; k < kPassUnroll; ++k) {
      const bool in = c0 + k < nc;
      dh[k] = in ? w[(c0 + k) * stride] : 0.f;
      de[k] = in ? dc[static_cast<size_t>(c0 + k) * nheads] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPassUnroll; ++k) {
      if (c0 + k < nc) {
        w[(c0 + k) * stride] = st;
        st = de[k] * st + dh[k];
      }
    }
  }
  h_out[bh * pn + e] = st;
}

template <int kMode>
cudaError_t launch_chunks(const Dims& d, int batch, bool vec, bool vec4,
                          const void* x,
                          const void* dt, const void* a_log, const void* bm,
                          const void* cm, const void* h0, const void* d_skip,
                          void* y, float* ws, float* dec, void* h_out,
                          cudaStream_t stream) {
  const unsigned smem = smem_layout(kMode, d.q, d.n_dim, d.ps).bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_chunk_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(d.nc, d.nheads * ((d.p_dim + d.ps - 1) / d.ps), batch);
  ssd_scan_chunk_kernel<kMode><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(h0),
      static_cast<const float*>(d_skip), static_cast<bf16*>(y), ws, dec,
      static_cast<float*>(h_out), d, vec, vec4);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// fp32 (the simt route).  h0 and d_skip may be null.  chunk: q = min(64,
// S).  Returns the CUDA error of the launch (cudaGetLastError(), 0 on
// success); the Python wrapper raises on anything else.
extern "C" int repro_ssd_scan_simt(const void* x, const void* dt,
                                   const void* a_log, const void* bm,
                                   const void* cm, const void* h0,
                                   const void* d_skip, void* y, void* h_out,
                                   int batch, int seqlen, int nheads,
                                   int p_dim, int ngroups, int n_dim,
                                   int chunk, void* stream) {
  return static_cast<int>(launch_simt(x, dt, a_log, bm, cm, h0, d_skip, y,
                                      h_out, batch, seqlen, nheads, p_dim,
                                      ngroups, n_dim, chunk, stream));
}

// bf16 (the mma route): x, B, C and y bf16, the rest fp32; h0 and d_skip
// may be null.  ws: S / chunk
// x B x H x (P N + 1) floats, unused (may be null) when S is one chunk.
// Launches the chunk-state kernel, the state pass and the chunk-output
// kernel (one fused launch for one chunk); returns the first CUDA error.
extern "C" int repro_ssd_scan_mma(const void* x, const void* dt,
                                  const void* a_log, const void* bm,
                                  const void* cm, const void* h0,
                                  const void* d_skip, void* y, void* h_out,
                                  void* ws, int batch, int seqlen, int nheads,
                                  int p_dim, int ngroups, int n_dim,
                                  int chunk, void* stream) {
  if (batch == 0 || seqlen == 0 || nheads == 0 || p_dim == 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || seqlen % chunk || ngroups <= 0 ||
      nheads % ngroups || n_dim <= 0 || n_dim > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{seqlen, nheads, p_dim, ngroups, n_dim, chunk, seqlen / chunk,
               p_dim < 64 ? round16(p_dim) : 64};
  const bool vec = p_dim % 8 == 0 && n_dim % 8 == 0 && aligned16(x) &&
                   aligned16(bm) && aligned16(cm) && aligned16(y);
  // the workspace comes from PyTorch's allocator, 16-byte aligned
  const bool vec4 = n_dim % 4 == 0 && aligned16(h0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.nc == 1)
    return static_cast<int>(launch_chunks<kFused>(
        d, batch, vec, vec4, x, dt, a_log, bm, cm, h0, d_skip, y, nullptr, nullptr,
        h_out, s));
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* states = static_cast<float*>(ws);
  float* dec = states + static_cast<size_t>(batch) * d.nc * nheads * p_dim * n_dim;
  cudaError_t e = launch_chunks<kStates>(d, batch, vec, vec4, x, dt, a_log, bm, cm,
                                         h0, d_skip, y, states, dec, h_out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pn = p_dim * n_dim;
  const dim3 grid((pn + kPassThreads - 1) / kPassThreads, nheads, batch);
  ssd_scan_state_pass<<<grid, kPassThreads, 0, s>>>(
      states, dec, static_cast<const float*>(h0), static_cast<float*>(h_out),
      d.nc, nheads, pn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_chunks<kOutputs>(
      d, batch, vec, vec4, x, dt, a_log, bm, cm, h0, d_skip, y, states, dec, h_out,
      s));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
