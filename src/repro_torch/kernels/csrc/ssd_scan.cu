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
// against ~2.0 GFLOP (2.0 us at the bf16 tensor-core peak).  This kernel is
// far from either: fp32 FMAs on CUDA cores out of shared memory.  What the
// design does:
//   * the TPU's sequential "arbitrary" chunk axis becomes a loop inside one
//     thread block, the fp32 state kept in shared memory across it, so the
//     state never goes to device memory between chunks;
//   * rows of the state along P are independent, so a block takes 16 of
//     them: the grid is (P / 16, H, B), 256 blocks at B = 1 on 132 SMs.
//     Each block recomputes its chunk's C B^T (the P-slices share it) and
//     reads its x columns, B and C once per chunk;
//   * per chunk, after one cooperative load of x, dt, B and C into shared
//     memory (converted to fp32): warp 0 scans dt A with shuffles, then
//     one thread per (i, j) score (a warp shares i, so C_i is a broadcast
//     and B_j rows padded to N + 1 floats fall in distinct banks), one
//     thread per (i, p) output, one thread per (p, n) state entry.
// Not done yet (see PERF.md): tensor cores (mma.sync / wgmma) for the four
// chunk products, register tiling, overlapping the next chunk's loads.
//
// The cumsum is a Kogge-Stone scan, not jnp.cumsum's order: exp(s_i - s_j)
// therefore differs from the reference by a few fp32 ulps of |s|; the tests
// hold fp32 y and states to 1e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSliceP = 16;     // state rows (of P) a thread block
constexpr int kMaxChunk = 64;   // positions a chunk (warp 0 scans 2 x 32)
constexpr int kMaxState = 256;  // N
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ h0,
                const float* __restrict__ d_skip, T* __restrict__ y,
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
      bs[j * ld + n] = to_f32(bm[src]);
      cs[j * ld + n] = to_f32(cm[src]);
    }
    for (int e = tid; e < q * kSliceP; e += kThreads) {
      const int j = e / kSliceP, pp = e % kSliceP;
      xs[e] = pp < np ? to_f32(x[((row0 + j) * nheads + h) * p_dim + p0 + pp])
                      : 0.f;
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
      y[((row0 + i) * nheads + h) * p_dim + p0 + pp] = from_f32<T>(v);
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

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* bm, const void* cm, const void* h0,
                   const void* d_skip, void* y, void* h_out, int batch,
                   int seqlen, int nheads, int p_dim, int ngroups, int n_dim,
                   int q, void* stream) {
  if (batch == 0 || seqlen == 0 || nheads == 0 || p_dim == 0) return cudaSuccess;
  if (q <= 0 || q > kMaxChunk || seqlen % q || ngroups <= 0 ||
      nheads % ngroups || n_dim <= 0 || n_dim > kMaxState)
    return cudaErrorInvalidValue;
  const size_t smem = smem_floats(q, n_dim) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p_dim + kSliceP - 1) / kSliceP, nheads, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(h0),
      static_cast<const float*>(d_skip), static_cast<T*>(y),
      static_cast<float*>(h_out), seqlen, nheads, p_dim, ngroups, n_dim, q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  h0 and d_skip may be
// null.  chunk: q = min(64, S).  Returns the CUDA error of the launch
// (cudaGetLastError(), 0 on success); the Python wrapper raises on anything
// else.
extern "C" int repro_ssd_scan(int dtype, const void* x, const void* dt,
                              const void* a_log, const void* bm,
                              const void* cm, const void* h0,
                              const void* d_skip, void* y, void* h_out,
                              int batch, int seqlen, int nheads, int p_dim,
                              int ngroups, int n_dim, int chunk,
                              void* stream) {
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, dt, a_log, bm, cm, h0, d_skip,
                                            y, h_out, batch, seqlen, nheads,
                                            p_dim, ngroups, n_dim, chunk,
                                            stream));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          x, dt, a_log, bm, cm, h0, d_skip, y, h_out, batch, seqlen, nheads,
          p_dim, ngroups, n_dim, chunk, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
