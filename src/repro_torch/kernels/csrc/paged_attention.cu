// Paged GQA attention over a blocked KV pool, written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_decode_attention_pallas  (_paged_kernel, lines 59-146): one new
//     token per request against every block below kv_len;
//   * paged_prefill_attention_pallas (_paged_prefill_kernel, lines 176-270):
//     one block_size prompt chunk at absolute positions q_start + [0, Sq),
//     causal (kpos <= qpos) over every block up to the chunk's frontier.
// Both are one templated kernel here: row r of the g * Sq query rows a
// thread block serves may attend the positions kpos < limit(r), where
//   decode:  limit(r) = kv_len[b]
//   prefill: limit(r) = q_start[b] + (r % Sq) + 1
//
// What bounds it on the H100: bytes.  Per (request, kv head) the kernel reads
// each live K/V block once (bs * D * 2 bytes each, bf16) and does 4 * g * Sq
// flops per K/V element, far below the ~295 flops per byte the tensor cores
// need before they, not HBM, are the limit.  What the design does about it:
//   * one thread block per (b, kv head) serves all g = Hq / Hkv q-heads that
//     share the kv head (the grouping at paged_attention.py:113), so a K/V
//     block is read from HBM once per kv head, not once per q-head;
//   * the walk stops at the last live block (kv_len for decode, the causal
//     frontier for prefill) and never passes the table's width M: blocks
//     past the frontier are never read;
//   * the walk goes by tiles of 64 keys (64 / bs table entries), and the
//     next tile's K and V are copied to shared memory (cp.async, 16 bytes a
//     thread) while the current tile is computed, so a request's blocks are
//     in flight together instead of one load-then-compute at a time;
//   * scores: one thread per (key, row group), 8 head-dim elements per
//     16-byte shared load of K, q broadcast from shared memory; PV: one
//     thread per head-dim column holds the accumulators of every row in
//     registers; an fp32 online softmax runs between the two (a warp per
//     row); the output is written once, in q's dtype.
// Not done yet (see PERF.md): split-KV across thread blocks (decode at B = 8
// fills 64 of 132 SMs, a prefill chunk 8), TMA, wgmma for the prefill tile.
//
// Semantics kept from the reference:
//   * a row with nothing to attend to returns 0 (l == 0 -> divide by 1,
//     paged_attention.py:97-99);
//   * a masked position gets p = 0, and positions at or past the last valid
//     key of the tile (kv_len, or the chunk's frontier) are never read, for
//     the scores or for V: they may hold stale bytes, and 0 * NaN is NaN.
//     Inside that range a position masked for one prefill row but not for a
//     later one is the chunk's own freshly written K/V, so its p = 0 times a
//     finite V adds exactly 0;
//   * block-table columns j >= M are never read, whatever kv_len says (an
//     idle slot's position keeps advancing past M * bs).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;                      // keys per tile
constexpr int kRowGroups = kThreads / kTileKeys;   // score rows split 2 ways
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

// Grid: one block per (b, kv head), blockIdx.x = b * hkv + h.
// q / out: (B, hkv * g, sq, d) contiguous, so the g * sq rows of (b, h) are
// one contiguous (rows, d) tile.  Pools: (n_blocks, hkv, bs, d) contiguous.
// RPT: score rows per thread; rows <= kRowGroups * RPT.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ lens, T* __restrict__ out,
                       int hkv, int g, int sq, int d, int bs, int max_blocks,
                       float scale, int causal) {
  constexpr int kRowsMax = kRowGroups * RPT;
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int rows = g * sq;
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

  const int64_t q_off = (static_cast<int64_t>(b) * hkv + h) * rows * d;
  for (int i = tid; i < rows * d; i += kThreads) q_s[i] = to_f32(q[q_off + i]) * scale;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int base = lens[b];
  const int reach = causal ? base + sq : base;  // the largest row limit
  int n_blk = reach > 0 ? (reach + bs - 1) / bs : 0;
  if (n_blk > max_blocks) n_blk = max_blocks;
  const int kv_end = max(0, min(reach, n_blk * bs));  // keys read: [0, kv_end)
  const int blocks_per_tile = kTileKeys / bs;
  const int n_tiles = (n_blk + blocks_per_tile - 1) / blocks_per_tile;
  const int32_t* bt_row = block_table + static_cast<int64_t>(b) * max_blocks;
  const int vec_per_row = d * static_cast<int>(sizeof(T)) / 16;
  const int vec_per_block = bs * vec_per_row;

  // copy the K/V blocks of one tile into a shared-memory stage, 16 bytes a
  // copy; entries past n_blk are not copied (and never read)
  auto issue = [&](int tile, int stage) {
    T* k_dst = kv_s + stage * stage_elems;
    T* v_dst = k_dst + kTileKeys * ld;
    for (int c = tid; c < blocks_per_tile * vec_per_block; c += kThreads) {
      const int kb = c / vec_per_block;
      const int j = tile * blocks_per_tile + kb;
      if (j >= n_blk) break;
      const int rem = c - kb * vec_per_block;
      const int key = rem / vec_per_row;
      const int col = (rem - key * vec_per_row) * (16 / static_cast<int>(sizeof(T)));
      const int64_t src = ((static_cast<int64_t>(bt_row[j]) * hkv + h) * bs + key) * d + col;
      const int dst = (kb * bs + key) * ld + col;
      __pipeline_memcpy_async(k_dst + dst, k_pool + src, 16);
      __pipeline_memcpy_async(v_dst + dst, v_pool + src, 16);
    }
    __pipeline_commit();
  };

  float o[kRowsMax];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) o[r] = 0.f;

  if (n_tiles > 0) issue(0, 0);
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      issue(tile + 1, stage ^ 1);   // overlaps this tile's math
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* k_t = kv_s + stage * stage_elems;
    const T* v_t = k_t + kTileKeys * ld;
    const int k0 = tile * kTileKeys;

    // scores: thread (key t, row group rg) for rows rg, rg + 2, ...
    {
      const int t = tid % kTileKeys;
      const int rg = tid / kTileKeys;
      float acc[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
      if (k0 + t < kv_end) {
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
        if (r < rows) p_s[r * kTileKeys + t] = acc[i];
      }
    }
    __syncthreads();

    // online softmax, a warp per row, over the row's valid keys t < nv
    for (int r = warp; r < rows; r += kThreads / 32) {
      const int limit = causal ? base + r % sq + 1 : base;
      const int nv = max(0, min(min(limit, kv_end) - k0, kTileKeys));
      const float m_prev = m_s[r];
      float mx = kNegInf;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, p_s[r * kTileKeys + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTileKeys; t += 32) {
        const float p = t < nv ? expf(p_s[r * kTileKeys + t] - m_new) : 0.f;
        p_s[r * kTileKeys + t] = p;
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

    // o = o * alpha + p @ V, one thread per head-dim column, keys < kv_end
    if (tid < d) {
      const int nv_max = max(0, min(kv_end - k0, kTileKeys));
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r)
        if (r < rows) o[r] *= alpha_s[r];
      int t = 0;
      for (; t + 4 <= nv_max; t += 4) {
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
      for (; t < nv_max; ++t) {
        const float v = to_f32(v_t[t * ld + tid]);
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r)
          if (r < rows) o[r] += p_s[r * kTileKeys + t] * v;
      }
    }
    __syncthreads();  // the stage and p_s are rewritten next
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) {
      if (r < rows) {
        const float l = l_s[r];
        out[q_off + static_cast<int64_t>(r) * d + tid] = from_f32<T>(o[r] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename T, int RPT>
cudaError_t launch_rpt(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_table, const void* lens, void* out,
                       int batch, int hkv, int g, int sq, int d, int bs,
                       int max_blocks, float scale, int causal, void* stream) {
  const size_t smem = smem_bytes<T>(g * sq, d);
  const cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  paged_attention_kernel<T, RPT><<<batch * hkv, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(lens), static_cast<T*>(out), hkv, g, sq, d,
      bs, max_blocks, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_table, const void* lens, void* out,
                   int batch, int hkv, int g, int sq, int d, int bs,
                   int max_blocks, float scale, int causal, void* stream) {
  if (batch == 0 || hkv == 0) return cudaSuccess;
  const int rows = g * sq;
  if (d % 8 || d > kMaxHeadDim || bs <= 0 || kTileKeys % bs || rows <= 0 ||
      rows > kRowGroups * 32)
    return cudaErrorInvalidValue;
#define REPRO_LAUNCH(RPT)                                                      \
  return launch_rpt<T, RPT>(q, k_pool, v_pool, block_table, lens, out, batch,  \
                            hkv, g, sq, d, bs, max_blocks, scale, causal, stream)
  if (rows <= kRowGroups * 1) REPRO_LAUNCH(1);
  if (rows <= kRowGroups * 2) REPRO_LAUNCH(2);
  if (rows <= kRowGroups * 4) REPRO_LAUNCH(4);
  if (rows <= kRowGroups * 8) REPRO_LAUNCH(8);
  if (rows <= kRowGroups * 16) REPRO_LAUNCH(16);
  REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
}

cudaError_t dispatch(int dtype, const void* q, const void* k_pool,
                     const void* v_pool, const void* block_table,
                     const void* lens, void* out, int batch, int hkv, int g,
                     int sq, int d, int bs, int max_blocks, float scale,
                     int causal, void* stream) {
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, block_table, lens, out, batch,
                           hkv, g, sq, d, bs, max_blocks, scale, causal, stream);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, block_table, lens, out,
                                   batch, hkv, g, sq, d, bs, max_blocks, scale,
                                   causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every entry returns the CUDA error of
// its launch (cudaGetLastError(), 0 on success); the Python wrapper raises
// on anything else.
extern "C" int repro_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* kv_len, void* out, int batch, int hkv,
    int g, int d, int bs, int max_blocks, float scale, void* stream) {
  return static_cast<int>(dispatch(dtype, q, k_pool, v_pool, block_table,
                                   kv_len, out, batch, hkv, g, 1, d, bs,
                                   max_blocks, scale, 0, stream));
}

extern "C" int repro_paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* q_start, void* out, int batch,
    int hkv, int g, int sq, int d, int bs, int max_blocks, float scale,
    void* stream) {
  return static_cast<int>(dispatch(dtype, q, k_pool, v_pool, block_table,
                                   q_start, out, batch, hkv, g, sq, d, bs,
                                   max_blocks, scale, 1, stream));
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
