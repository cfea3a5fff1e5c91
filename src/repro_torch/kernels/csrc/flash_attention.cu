// Dense flash-attention forward (GQA, causal and/or sliding window), written
// for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/attention.py:73, kernel
// body _flash_kernel at lines 28-68): q (B, Hq, Sq, D) against k / v
// (B, Hkv, Sk, D), q-head h reading kv head h / g (g = Hq / Hkv), queries
// right-aligned to the keys (qpos = i + Sk - Sq), an optional causal mask
// (kpos <= qpos) and an optional window (kpos > qpos - window), an fp32
// online softmax and accumulator, the output in q's dtype.  causal, window
// and scale are runtime arguments (window <= 0: none).  Any Sq and Sk are
// taken (the Pallas kernel needs multiples of its 128 tile): the last key
// tile and the last query tile are cut at Sk and Sq.
//
// What bounds it on the H100: at the serving path's shapes (B = 1, Hq 16,
// Hkv 8, D 128, S <= 1024, causal) bytes and operations come out about even
// (S = 900: 11 MB of q / k / v / out, 3.3 GFLOP; both about 3.3 us), and
// this kernel, on CUDA cores in fp32, is far from either.  What the design
// does:
//   * one thread block per (q tile, b, kv head) serves all g q-heads that
//     share the kv head: rows = g * bq (at most 64) query rows, so a K/V tile
//     is read from HBM once per kv head and q tile, not once per q-head;
//   * K and V go through shared memory in tiles of 64 keys, the next tile
//     copied (cp.async, 16 bytes a thread) while the current one is computed;
//   * key tiles wholly outside the causal / window band of every row of the
//     q tile are skipped (see below for the one exception);
//   * scores: one thread per (key, row group), 8 head-dim elements per
//     16-byte shared load of K, q broadcast from shared memory; PV: one
//     thread per head-dim column holds every row's accumulator in registers;
//     an fp32 online softmax runs between the two (a warp per row).
// Not done yet (see PERF.md): tensor cores (mma.sync / wgmma), TMA, more
// than one thread block per SM.
//
// Semantics kept from the reference, not from a textbook kernel:
//   * a masked logit is the finite -1e30, not -inf.  A row whose keys are
//     all masked (causal with Sq > Sk: qpos < 0) therefore gets p =
//     exp(-1e30 - (-1e30)) = 1 for every key and ends as the mean of V over
//     all Sk keys, as _flash_kernel and attention_xla give; the l == 0 guard
//     only ever divides by 1;
//   * skipping a masked tile changes nothing for a row with at least one
//     valid key: a masked tile before its first valid key is wiped by alpha =
//     exp(-1e30 - m) = 0 once that key arrives, one after it adds p = 0.  A
//     row with no valid key keeps every tile's p = 1, so a q tile holding
//     such a row must visit every key tile, or it would get 0 where the
//     reference gets mean(V).  With window >= 1 that happens only under the
//     causal mask, for qpos < 0;
//   * keys at or past Sk do not exist: they are never read and add nothing,
//     not even to a fully masked row.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;                      // keys per tile
constexpr int kRowGroups = kThreads / kTileKeys;   // score rows split 2 ways
constexpr int kMaxRows = 64;                       // g * bq rows a block
constexpr int kMaxHeadDim = kThreads;              // one PV column a thread
constexpr float kNegInf = -1e30f;

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

// eight consecutive elements from 16-byte-aligned shared memory, as floats
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K/V rows in shared memory are padded by 16 bytes, so the 16-byte loads
// of a warp's consecutive keys fall in distinct banks.
template <typename T> __host__ __device__ constexpr int row_stride(int d) {
  return d + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ size_t smem_bytes(int rows, int d) {
  return 2 * 2 * static_cast<size_t>(kTileKeys) * row_stride<T>(d) * sizeof(T) +
         (static_cast<size_t>(rows) * d + static_cast<size_t>(rows) * kTileKeys +
          3 * static_cast<size_t>(rows)) * sizeof(float);
}

// Grid: (q tiles, B * Hkv); blockIdx.y = b * hkv + h.  q / out: (B, hkv * g,
// sq, d) contiguous; k / v: (B, hkv, sk, d) contiguous.  Row r of a block is
// q-head h * g + r / bq at query q0 + r % bq.  RPT: score rows per thread;
// rows <= kRowGroups * RPT.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hkv,
                       int g, int sq, int sk, int d, int bq, float scale,
                       int causal, int window) {
  constexpr int kRowsMax = kRowGroups * RPT;
  const int b = blockIdx.y / hkv;
  const int h = blockIdx.y % hkv;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, sq - q0);          // queries of this tile
  const int rows = g * bq;
  const int shift = sk - sq;                // qpos = query index + shift
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_stride<T>(d);
  const int stage_elems = 2 * kTileKeys * ld;       // K then V of one tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);               // [2][K|V][64][ld]
  float* q_s = reinterpret_cast<float*>(kv_s + 2 * stage_elems);  // (rows, d)
  float* p_s = q_s + rows * d;                            // (rows, 64)
  float* m_s = p_s + rows * kTileKeys;                    // (rows,)
  float* l_s = m_s + rows;                                // (rows,)
  float* alpha_s = l_s + rows;                            // (rows,)

  const int64_t head0 = static_cast<int64_t>(b) * hkv * g + static_cast<int64_t>(h) * g;
  auto row_offset = [&](int r) -> int64_t {   // element offset of row r in q / out
    return ((head0 + r / bq) * sq + q0 + r % bq) * d;
  };
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d;
    q_s[i] = r % bq < nq ? to_f32(q[row_offset(r) + i % d]) : 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // Key tiles to visit.  A row's valid keys [lo(qpos), hi(qpos)] move right
  // as qpos grows, so the band of this tile's rows runs from lo(first row)
  // to hi(last row); outside it every row is masked.  A tile holding a row
  // with no valid key at all (causal, qpos < 0) visits every key tile.
  const int qpos_first = q0 + shift;
  const int qpos_last = q0 + nq - 1 + shift;
  int k_begin = 0, k_end = sk;
  if (!(causal && qpos_first < 0)) {
    if (window > 0) k_begin = max(0, qpos_first - window + 1);
    if (causal) k_end = min(sk, qpos_last + 1);
  }
  const int t_begin = k_begin / kTileKeys;
  const int t_end = (k_end + kTileKeys - 1) / kTileKeys;
  const int vec_per_row = d * static_cast<int>(sizeof(T)) / 16;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + h) * sk * d;

  // copy the K/V rows of one tile into a shared-memory stage, 16 bytes a
  // copy; keys at or past sk are not copied (and never read)
  auto issue = [&](int tile, int stage) {
    T* k_dst = kv_s + stage * stage_elems;
    T* v_dst = k_dst + kTileKeys * ld;
    const int k0 = tile * kTileKeys;
    const int n = min(kTileKeys, sk - k0);
    for (int c = tid; c < n * vec_per_row; c += kThreads) {
      const int key = c / vec_per_row;
      const int col = (c - key * vec_per_row) * (16 / static_cast<int>(sizeof(T)));
      const int64_t src = kv_base + static_cast<int64_t>(k0 + key) * d + col;
      __pipeline_memcpy_async(k_dst + key * ld + col, k + src, 16);
      __pipeline_memcpy_async(v_dst + key * ld + col, v + src, 16);
    }
    __pipeline_commit();
  };

  float o[kRowsMax];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) o[r] = 0.f;

  if (t_begin < t_end) issue(t_begin, 0);
  __syncthreads();

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int stage = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      issue(tile + 1, stage ^ 1);   // overlaps this tile's math
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* k_t = kv_s + stage * stage_elems;
    const T* v_t = k_t + kTileKeys * ld;
    const int k0 = tile * kTileKeys;
    const int ne = min(kTileKeys, sk - k0);   // keys that exist in the tile

    // scores: thread (key t, row group rg) for rows rg, rg + 2, ...
    {
      const int t = tid % kTileKeys;
      const int rg = tid / kTileKeys;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      if (t < ne) {
        for (int e = 0; e < d; e += 8) {
          float kx[8];
          load8(k_t + t * ld + e, kx);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = rg + kRowGroups * i;
            if (r < rows) {
              float qx[8];
              load8(q_s + r * d + e, qx);
#pragma unroll
              for (int u = 0; u < 8; ++u) acc[i] += qx[u] * kx[u];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + kRowGroups * i;
        if (r < rows) p_s[r * kTileKeys + t] = acc[i] * scale;
      }
    }
    __syncthreads();

    // online softmax, a warp per row, over the tile's existing keys t < ne;
    // masked keys take the logit -1e30
    for (int r = warp; r < rows; r += kThreads / 32) {
      const int qpos = q0 + r % bq + shift;
      float* pr = p_s + r * kTileKeys;
      float mx = kNegInf;
      for (int t = lane; t < ne; t += 32) {
        const int kpos = k0 + t;
        const bool masked = (causal && kpos > qpos) ||
                            (window > 0 && kpos <= qpos - window);
        const float s = masked ? kNegInf : pr[t];
        pr[t] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTileKeys; t += 32) {
        const float p = t < ne ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p @ V, one thread per head-dim column, keys t < ne
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r)
        if (r < rows) o[r] *= alpha_s[r];
      int t = 0;
      for (; t + 4 <= ne; t += 4) {
        const float v0 = to_f32(v_t[t * ld + tid]);
        const float v1 = to_f32(v_t[(t + 1) * ld + tid]);
        const float v2 = to_f32(v_t[(t + 2) * ld + tid]);
        const float v3 = to_f32(v_t[(t + 3) * ld + tid]);
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r) {
          if (r < rows) {
            const float4 p = *reinterpret_cast<const float4*>(p_s + r * kTileKeys + t);
            o[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
      for (; t < ne; ++t) {
        const float vt = to_f32(v_t[t * ld + tid]);
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r)
          if (r < rows) o[r] += p_s[r * kTileKeys + t] * vt;
      }
    }
    __syncthreads();  // the stage and p_s are rewritten next
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) {
      if (r < rows && r % bq < nq) {
        const float l = l_s[r];
        out[row_offset(r) + tid] = from_f32<T>(o[r] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename T, int RPT>
cudaError_t launch_rpt(const void* q, const void* k, const void* v, void* out,
                       int batch, int hkv, int g, int sq, int sk, int d,
                       int bq, float scale, int causal, int window,
                       void* stream) {
  const size_t smem = smem_bytes<T>(g * bq, d);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + bq - 1) / bq, batch * hkv);
  flash_attention_kernel<T, RPT><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hkv, g, sq, sk, d, bq,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int hkv, int g, int sq, int sk, int d,
                   float scale, int causal, int window, void* stream) {
  if (batch == 0 || hkv == 0 || sq == 0) return cudaSuccess;
  if (d % 8 || d > kMaxHeadDim || g <= 0 || g > kMaxRows || sk <= 0)
    return cudaErrorInvalidValue;
  const int bq = std::min(kMaxRows / g, sq);   // queries a block, g * bq rows
  const int rows = g * bq;
#define REPRO_LAUNCH(RPT)                                                  \
  return launch_rpt<T, RPT>(q, k, v, out, batch, hkv, g, sq, sk, d, bq,    \
                            scale, causal, window, stream)
  if (rows <= kRowGroups * 1) REPRO_LAUNCH(1);
  if (rows <= kRowGroups * 2) REPRO_LAUNCH(2);
  if (rows <= kRowGroups * 4) REPRO_LAUNCH(4);
  if (rows <= kRowGroups * 8) REPRO_LAUNCH(8);
  if (rows <= kRowGroups * 16) REPRO_LAUNCH(16);
  REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: 0 or 1; window <= 0: none.
// Returns the CUDA error of the launch (cudaGetLastError(), 0 on success);
// the Python wrapper raises on anything else.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int hkv, int g, int sq, int sk, int d,
                                     float scale, int causal, int window,
                                     void* stream) {
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(q, k, v, out, batch, hkv, g, sq,
                                            sk, d, scale, causal, window,
                                            stream));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(q, k, v, out, batch, hkv,
                                                    g, sq, sk, d, scale,
                                                    causal, window, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
