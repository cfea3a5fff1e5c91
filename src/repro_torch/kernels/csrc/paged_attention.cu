// Paged GQA attention over a blocked KV pool, written for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/paged_attention.py:
//   * paged_decode_attention_pallas  (_paged_kernel, lines 59-146): one new
//     token per request against every position below kv_len;
//   * paged_prefill_attention_pallas (_paged_prefill_kernel, lines 176-270):
//     one block_size prompt chunk at absolute positions q_start + [0, Sq),
//     causal (kpos <= qpos) over every block up to the chunk's frontier.
// Row r of the g * Sq query rows of a (request, kv head) may attend the
// positions kpos < limit(r), where
//   decode:  limit(r) = kv_len[b]                  (Sq = 1)
//   prefill: limit(r) = q_start[b] + (r % Sq) + 1
// so decode is the prefill's rule with q_start = kv_len - 1 and Sq = 1.
// Position kpos lives in block table[b][kpos / bs] at row kpos % bs, for any
// block size bs: the kernels walk 64-key tiles and fetch each key's 16-byte
// pieces from its own block.
//
// What bounds it on the H100: bytes.  Per (request, kv head) a kernel reads
// each live K/V position once (D * 2 bytes each, bf16) and does 4 * g * Sq
// flops per K/V element, far below the ~295 flops per byte the tensor cores
// need before they, not HBM, are the limit.  Two kernels, picked by dtype
// (paged_attention.route):
//
// paged_mma_kernel, tensor cores: bf16 decode and prefill (route mma):
//   * a block takes 64 of the g * Sq rows (four warps of 16, q in registers
//     as mma.sync m16n8k16 A fragments), any g * Sq (grid x: b, kv head,
//     row tile); a warp with no real row does no math (decode's g = 2 keeps
//     one warp busy: the kernel is bound by bytes, and the other three
//     copy); K / V tiles of 64 keys come through shared memory by cp.async,
//     the next tile's copy overlapping this one's math;
//   * split-KV: grid y splits the row's key tiles, a contiguous share each
//     (none past kv_len or the frontier: an empty partial), so a few
//     requests fill the card; the split count follows the table's width and
//     the SM count (paged_attention.decode_plan / prefill_plan), never
//     kv_len or q_start (no host sync) or B (a row's output does not
//     depend on its batch);
//   * each split writes an fp32 partial (o, m, l) of its rows; the last
//     block of the row tile to arrive (an atomic counter, reset by that
//     block) combines them in split order, in the same launch, so reruns
//     are bit-identical;
//   * s = q k^T and o += p v on the tensor cores, p rounded to bf16, the
//     online softmax on the fragments in fp32 (log2 units, ex2.approx);
//     masked keys get -inf, so a row with no key seen yet keeps p = 0.
//
// paged_attention_kernel, CUDA cores: fp32 decode and prefill (route simt;
// the fp32 paged == dense identity on the card rests on its sums, so it
// keeps one block per row tile, every key in order, no split):
//   * one thread block per (b, kv head, 64-row tile) serves the g = Hq / Hkv
//     q-heads that share the kv head (the grouping at paged_attention.py:113),
//     so a K/V block is read from HBM once per kv head, not once per q-head;
//   * the walk stops at the last live key (kv_len for decode, the causal
//     frontier for prefill) and never passes the table's width M;
//   * the walk goes by tiles of 64 keys, and the next tile's K and V are
//     copied to shared memory (cp.async, 16 bytes a thread) while the
//     current tile is computed;
//   * scores: one thread per (key, row group), 8 head-dim elements per
//     16-byte shared load of K, q broadcast from shared memory; PV: one
//     thread per head-dim column holds the accumulators of every row in
//     registers; an fp32 online softmax runs between the two (a warp per
//     row); the output is written once.
// Semantics kept from the reference:
//   * a row with nothing to attend to (kv_len == 0) returns 0 (l == 0 ->
//     divide by 1, paged_attention.py:97-99);
//   * a masked position gets p = 0, and positions at or past the last valid
//     key of the tile (kv_len, or the chunk's frontier) are never read, for
//     the scores or for V: they may hold stale bytes, and 0 * NaN is NaN
//     (the tensor-core kernel multiplies whole tiles, so it zero-fills those
//     rows of K and V in shared memory instead of reading them).
//     Inside that range a position masked for one prefill row but not for a
//     later one is the chunk's own freshly written K/V, so its p = 0 times a
//     finite V adds exactly 0;
//   * block-table columns j >= M are never read, whatever kv_len says (an
//     idle slot's position keeps advancing past M * bs);
//   * the output is in q's dtype.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;                      // keys per tile
constexpr int kRowGroups = kThreads / kTileKeys;   // score rows split 2 ways
constexpr int kRows = kRowGroups * 32;             // rows a block (a row tile)
constexpr int kMaxHeadDim = kThreads;              // one PV column a thread
constexpr float kNegInf = -1e30f;

// eight consecutive floats from 16-byte-aligned shared memory
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
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
__host__ __device__ constexpr int row_stride(int d) { return d + 4; }

__host__ __device__ size_t smem_bytes(int rows, int d) {
  return 2 * 2 * static_cast<size_t>(kTileKeys) * row_stride(d) * sizeof(float) +
         (static_cast<size_t>(rows) * d + static_cast<size_t>(rows) * kTileKeys +
          3 * static_cast<size_t>(rows)) * sizeof(float);
}

// Grid: one block per (b, kv head, 64-row tile of its g * sq rows),
// blockIdx.x = b * hkv + h, blockIdx.y = the row tile.
// q / out: (B, hkv * g, sq, d) contiguous, so the g * sq rows of (b, h) are
// one contiguous (rows, d) tile.  Pools: (n_blocks, hkv, bs, d) contiguous.
// RPT: score rows per thread; a block's rows <= kRowGroups * RPT.
template <int RPT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int32_t* __restrict__ block_table,
                       const int32_t* __restrict__ lens, float* __restrict__ out,
                       int hkv, int g, int sq, int d, int bs, int max_blocks,
                       float scale, int causal) {
  constexpr int kRowsMax = kRowGroups * RPT;
  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int rows_all = g * sq;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, rows_all - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_stride(d);
  const int stage_elems = 2 * kTileKeys * ld;       // K then V of one tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);       // [2][K|V][64][ld]
  float* q_s = kv_s + 2 * stage_elems;                    // (rows, d)
  float* p_s = q_s + rows * d;                            // (rows, 64)
  float* m_s = p_s + rows * kTileKeys;                    // (rows,)
  float* l_s = m_s + rows;                                // (rows,)
  float* alpha_s = l_s + rows;                            // (rows,)

  const int64_t q_off = (static_cast<int64_t>(b) * hkv + h) * rows_all * d +
                        static_cast<int64_t>(r0) * d;
  for (int i = tid; i < rows * d; i += kThreads) q_s[i] = q[q_off + i] * scale;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int base = lens[b];
  const int reach = causal ? base + sq : base;  // the largest row limit
  // keys read: [0, kv_end), never past the table's M blocks
  const int kv_end = max(0, min(reach, max_blocks * bs));
  const int n_tiles = (kv_end + kTileKeys - 1) / kTileKeys;
  const int32_t* bt_row = block_table + static_cast<int64_t>(b) * max_blocks;
  const int vec_per_row = d / 4;                // 16-byte pieces of a key

  // copy the keys of one tile below kv_end into a shared-memory stage, 16
  // bytes a copy, each key from its own block (any bs); keys at or past
  // kv_end are not copied (and never read)
  auto issue = [&](int tile, int stage) {
    float* k_dst = kv_s + stage * stage_elems;
    float* v_dst = k_dst + kTileKeys * ld;
    const int k0 = tile * kTileKeys;
    const int n_keys = min(kTileKeys, kv_end - k0);
    for (int c = tid; c < n_keys * vec_per_row; c += kThreads) {
      const int key = c / vec_per_row;
      const int col = (c - key * vec_per_row) * 4;
      const int kpos = k0 + key;
      const int j = kpos / bs;
      const int64_t src =
          ((static_cast<int64_t>(bt_row[j]) * hkv + h) * bs + (kpos - j * bs)) * d + col;
      const int dst = key * ld + col;
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
    const float* k_t = kv_s + stage * stage_elems;
    const float* v_t = k_t + kTileKeys * ld;
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
      const int limit = causal ? base + (r0 + r) % sq + 1 : base;
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
        const float v0 = v_t[t * ld + tid];
        const float v1 = v_t[(t + 1) * ld + tid];
        const float v2 = v_t[(t + 2) * ld + tid];
        const float v3 = v_t[(t + 3) * ld + tid];
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r) {
          if (r < rows) {
            const float4 p = *reinterpret_cast<const float4*>(p_s + r * kTileKeys + t);
            o[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
          }
        }
      }
      for (; t < nv_max; ++t) {
        const float v = v_t[t * ld + tid];
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
        out[q_off + static_cast<int64_t>(r) * d + tid] = o[r] / (l == 0.f ? 1.f : l);
      }
    }
  }
}

template <int RPT>
cudaError_t launch_rpt(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_table, const void* lens, void* out,
                       int batch, int hkv, int g, int sq, int d, int bs,
                       int max_blocks, float scale, int causal, void* stream) {
  const int rows_all = g * sq;
  const size_t smem = smem_bytes(std::min(rows_all, kRows), d);
  const cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * hkv, (rows_all + kRows - 1) / kRows);
  paged_attention_kernel<RPT><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(lens), static_cast<float*>(out), hkv, g, sq, d,
      bs, max_blocks, scale, causal);
  return cudaGetLastError();
}

// any g * sq, in 64-row tiles (grid y); RPT from a block's rows
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_table, const void* lens, void* out,
                   int batch, int hkv, int g, int sq, int d, int bs,
                   int max_blocks, float scale, int causal, void* stream) {
  if (batch == 0 || hkv == 0) return cudaSuccess;
  const int rows_all = g * sq;
  if (d <= 0 || d % 8 || d > kMaxHeadDim || bs <= 0 || max_blocks < 0 ||
      rows_all <= 0 || (rows_all + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const int rows = std::min(rows_all, kRows);   // a block's rows at most
#define REPRO_LAUNCH(RPT)                                                      \
  return launch_rpt<RPT>(q, k_pool, v_pool, block_table, lens, out, batch,     \
                         hkv, g, sq, d, bs, max_blocks, scale, causal, stream)
  if (rows <= kRowGroups * 1) REPRO_LAUNCH(1);
  if (rows <= kRowGroups * 2) REPRO_LAUNCH(2);
  if (rows <= kRowGroups * 4) REPRO_LAUNCH(4);
  if (rows <= kRowGroups * 8) REPRO_LAUNCH(8);
  if (rows <= kRowGroups * 16) REPRO_LAUNCH(16);
  REPRO_LAUNCH(32);
#undef REPRO_LAUNCH
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 decode and prefill on tensor cores (mma.sync m16n8k16, fp32
// accumulators), split over the keys.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;     // four warps
constexpr int kRows = 64;         // query rows a block (a row tile), 16 a warp
constexpr int kKeys = 64;         // keys a tile
constexpr int kMaxSplits = 64;    // a lane's two splits in the combine
constexpr float kLog2e = 1.4426950408889634f;

// Shared rows of DP bf16 padded by 16 bytes, so the eight 16-byte row reads
// of an ldmatrix fall in eight distinct bank groups (as flash_attention.cu).
template <int DP> struct Layout {
  static constexpr int kLd = DP + 8;
  static constexpr int kTile = kRows * kLd;          // elements of a tile
  static constexpr size_t kBytes = 5 * kTile * sizeof(bf16);  // Q, K[2], V[2]
  // floats of one split's partial: o (kRows x DP), then m and l (kRows each)
  static constexpr int kPart = kRows * (DP + 2);
};

// The first key tile of split s when `splits` splits share n_tiles tiles:
// split s walks [first(s), first(s + 1)), every tile exactly once
__device__ __forceinline__ int first_tile(int s, int n_tiles, int splits) {
  return static_cast<int>(static_cast<long long>(s) * n_tiles / splits);
}

// Grid: (B * hkv * row tiles, splits); unit = blockIdx.x = (b * hkv + h) *
// row_tiles + rt serves the rows rt * 64 .. + 63 of the g * sq query rows
// of (b, kv head h) (row r: q-head h * g + r / sq, query r % sq at position
// base + r % sq, base = lens[b] - decode: q_start for the prefill, kv_len - 1
// for decode, whose sq is 1).  q / out: (B, hkv * g, sq, d) contiguous;
// pools: (n_blocks, hkv, bs, d) contiguous, any bs (bs_log = log2 bs for a
// power of two, a shift, else -1, a division).  DP: the head dim the tensor
// cores see (d rounded up to 16, 32, 64 or 128; zero columns in shared
// memory, never stored).
//
// The rows' frontier is kv_end = min(base + sq, max_blocks * bs); its keys
// are cut into n_tiles tiles of 64, and split blockIdx.y walks its share of
// them (none, past the frontier: its partial is empty).  With one
// split a block writes its rows' output; with more, each block writes an
// fp32 partial (o unnormalized, m in log2 units, l), and the last block of
// the unit to arrive (a counter in `counters`, reset by that block)
// combines the partials in split order.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
paged_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                 const bf16* __restrict__ v_pool, const int32_t* __restrict__ block_table,
                 const int32_t* __restrict__ lens, bf16* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters, int hkv, int g,
                 int sq, int d, int bs, int bs_log, int max_blocks, int decode,
                 float scale_log2) {
  using L = Layout<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kKSteps = DP / 16;     // k16 steps of q k^T
  constexpr int kDTiles = DP / 8;      // n8 tiles of o
  const int rows_all = g * sq;
  const int row_tiles = (rows_all + kRows - 1) / kRows;
  const int unit = blockIdx.x;
  const int bh = unit / row_tiles;
  const int r0 = (unit - bh * row_tiles) * kRows;
  const int b = bh / hkv, h = bh - b * hkv;
  const int nr = min(kRows, rows_all - r0);
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, quad = lane & 3;   // fragment row, column pair

  const int base = lens[b] - decode;
  const int kv_end = max(0, min(base + sq, max_blocks * bs));   // keys read
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const int t_begin = first_tile(split, n_tiles, splits);
  const int t_end = first_tile(split + 1, n_tiles, splits);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* k_s = q_s + L::kTile;                        // [2][64][kLd]
  bf16* v_s = k_s + 2 * L::kTile;                    // [2][64][kLd]

  const int vec = d / 8;                // 16-byte chunks of a row in memory
  if (vec < DP / 8) {                   // zero the padded columns once
    const int pad = DP / 8 - vec;
    for (int i = tid; i < 5 * kRows * pad; i += kThreads) {
      const int row = i / pad, ch = vec + i % pad;
      *reinterpret_cast<uint4*>(q_s + row * kLd + ch * 8) = make_uint4(0, 0, 0, 0);
    }
  }
  // Copies into shared tiles: thread t moves the 16-byte column t % (DP /
  // 8) of rows t / (DP / 8) + i (128 / (DP / 8)).  A key at or past the
  // frontier is zero-filled, not read (stale pool bytes may be NaN, and the
  // tensor cores multiply the whole tile: p = 0 times NaN is NaN), and no
  // table entry past the frontier (so none at or past max_blocks) is read.
  constexpr int kChunks = DP / 8, kRowStep = kThreads / kChunks;
  constexpr int kCopies = kRows / kRowStep;
  const int my_ch = tid % kChunks, my_row = tid / kChunks;
  const bool copies = my_ch < vec;
  const int32_t* bt_row = block_table + static_cast<int64_t>(b) * max_blocks;
  const int64_t blk_stride = static_cast<int64_t>(hkv) * bs * d;   // a pool block
  const int64_t my_off = static_cast<int64_t>(h) * bs * d + my_ch * 8;
  const uint32_t my_smem = (my_row * kLd + my_ch * 8) * sizeof(bf16);

  auto copy_kv = [&](int tile, int slot) {
    if (!copies) return;
    const uint32_t so = my_smem + slot * L::kTile * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int key = tile * kKeys + my_row + i * kRowStep;
      const bool ok = key < kv_end;
      const int j = bs_log >= 0 ? key >> bs_log : key / bs;   // its block
      const int64_t src =
          ok ? bt_row[j] * blk_stride + my_off + static_cast<int64_t>(key - j * bs) * d : 0;
      const uint32_t dst = so + i * kRowStep * kLd * sizeof(bf16);
      cp_async16(smem_u32(k_s) + dst, k_pool + src, ok);
      cp_async16(smem_u32(v_s) + dst, v_pool + src, ok);
    }
  };
  if (t_begin < t_end) {
    if (copies) {
      const bf16* q_src = q + (static_cast<int64_t>(bh) * rows_all + r0) * d + my_ch * 8;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int row = my_row + i * kRowStep;
        cp_async16(smem_u32(q_s) + my_smem + i * kRowStep * kLd * sizeof(bf16),
                   row < nr ? q_src + static_cast<int64_t>(row) * d : q, row < nr);
      }
    }
    copy_kv(t_begin, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // key < lim[x] is visible to the fragment row gid + 8 x of this warp (kpos
  // <= qpos and below the frontier); a row past the block's is given none
  int lim[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r0 + warp * 16 + gid + 8 * x;
    lim[x] = r < rows_all ? min(base + r % sq + 1, kv_end) : 0;
  }
  const bool w_active = warp * 16 < nr;   // a warp with no real row does no math
  uint32_t qf[kKSteps][4];               // this warp's 16 query rows, A fragments
  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows gid and gid + 8, log2 units
  float l_r[2] = {0.f, 0.f};              // this thread's share of each row sum

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int i = tile - t_begin;
    if (tile + 1 < t_end) {             // the next tile's copy overlaps this one
      copy_kv(tile + 1, (i + 1) & 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (w_active) {
      if (i == 0) {
#pragma unroll
        for (int kd = 0; kd < kKSteps; ++kd)
          ldsm_x4(qf[kd], smem_u32(q_s + (warp * 16 + (lane & 15)) * kLd + kd * 16 +
                                   (lane >> 4) * 8));
      }
      const bf16* k_t = k_s + (i & 1) * L::kTile;
      const bf16* v_t = v_s + (i & 1) * L::kTile;
      // s = q k^T: 16 rows x 64 keys, eight n8 tiles
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kKSteps; ++kd) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {   // keys np * 16 .. + 15
          uint32_t r[4];
          ldsm_x4(r, smem_u32(k_t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                              kd * 16 + ((lane >> 3) & 1) * 8));
          mma16816(s[2 * np], qf[kd], r[0], r[1]);
          mma16816(s[2 * np + 1], qf[kd], r[2], r[3]);
        }
      }
      // logits in log2 units; a key the row may not see gets -inf (p = 0)
      const int k0 = tile * kKeys;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + quad * 2 + (e & 1);
          s[j][e] = key < lim[e >> 1] ? s[j][e] * scale_log2 : -INFINITY;
        }
      // online softmax on the fragments: a row lives in the four threads of
      // a quad.  A row with no visible key yet keeps m = -inf, and its
      // exponent is taken against 0, so p = 0 and alpha = 0, never NaN
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = ex2(m_r[r] - mu[r]);
        m_r[r] = mx[r];
      }
      uint32_t pa[4][4];                  // p as A fragments, 16 keys each
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - mu[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }
      // o += p v: V's rows are keys, read transposed into B fragments
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, smem_u32(v_t + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kLd +
                                    dp * 16 + (lane >> 4) * 8));
          mma16816(o[2 * dp], pa[kk], r[0], r[1]);
          mma16816(o[2 * dp + 1], pa[kk], r[2], r[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this slot before it is refilled
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
    l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
  }
  if (splits == 1) {                    // the row's output; nothing to combine
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = warp * 16 + gid + 8 * x;
      if (row >= nr) continue;
      const float l = l_r[x] == 0.f ? 1.f : l_r[x];   // nothing seen: 0
      bf16* dst = out + (static_cast<int64_t>(bh) * rows_all + r0 + row) * d;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        if (j * 8 < d)
          *reinterpret_cast<uint32_t*>(dst + j * 8 + quad * 2) =
              pack_bf16(o[j][2 * x] / l, o[j][2 * x + 1] / l);
    }
    return;
  }

  // this split's partial: o of the rows that saw a key, m and l of all
  float* po = part + (static_cast<int64_t>(unit) * splits + split) * L::kPart;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = warp * 16 + gid + 8 * x;
    if (quad == 0) {
      po[kRows * DP + row] = m_r[x];
      po[kRows * DP + kRows + row] = l_r[x];
    }
    if (l_r[x] != 0.f) {
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<float2*>(po + row * DP + j * 8 + quad * 2) =
            make_float2(o[j][2 * x], o[j][2 * x + 1]);
    }
  }
  // the last block of the unit to arrive combines (each thread's writes
  // made visible device-wide before its block counts itself in)
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + unit, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pu = part + static_cast<int64_t>(unit) * splits * L::kPart;
  // each row's weights exp2(m_s - max m) and sum first, a lane a split
  // (splits <= 64), into shared memory (the tiles are done with)
  float* w_s = reinterpret_cast<float*>(smem_raw);     // [kRows][splits]
  float* l_s = w_s + kRows * splits;                    // [kRows]
  for (int row = warp; row < nr; row += kThreads / 32) {
    float m[2], l[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int sp = lane + 32 * k;
      const float* pm = pu + sp * L::kPart + kRows * DP;
      l[k] = sp < splits ? __ldcg(pm + kRows + row) : 0.f;
      m[k] = l[k] != 0.f ? __ldcg(pm + row) : -INFINITY;
    }
    const float mmax = warp_max(fmaxf(m[0], m[1]));
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int sp = lane + 32 * k;
      const float w = l[k] != 0.f ? ex2(m[k] - mmax) : 0.f;
      if (sp < splits) w_s[row * splits + sp] = w;
      lsum += w * l[k];
    }
    lsum = warp_sum(lsum);                 // a fixed shuffle tree
    if (lane == 0) l_s[row] = lsum == 0.f ? 1.f : lsum;
  }
  __syncthreads();
  // then o: a thread a (row, 4 columns), kBatch splits' loads in flight
  constexpr int kBatch = 16;
  const int quads = d / 4;
  for (int it = tid; it < nr * quads; it += kThreads) {
    const int row = it / quads, col = (it - row * quads) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp0 = 0; sp0 < splits; sp0 += kBatch) {   // in split order
      float4 v[kBatch];
      float w[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int sp = sp0 + k;
        w[k] = sp < splits ? w_s[row * splits + sp] : 0.f;
        v[k] = w[k] != 0.f ? __ldcg(reinterpret_cast<const float4*>(
                                 pu + sp * L::kPart + row * DP + col))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        acc[0] += w[k] * v[k].x; acc[1] += w[k] * v[k].y;
        acc[2] += w[k] * v[k].z; acc[3] += w[k] * v[k].w;
      }
    }
    const float l = l_s[row];
    *reinterpret_cast<uint2*>(out + (static_cast<int64_t>(bh) * rows_all + r0 + row) * d +
                              col) =
        make_uint2(pack_bf16(acc[0] / l, acc[1] / l), pack_bf16(acc[2] / l, acc[3] / l));
  }
  if (tid == 0) counters[unit] = 0;      // ready for the next launch
}

template <int DP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_table, const void* lens, void* out,
                   void* part, void* counters, int batch, int hkv, int g,
                   int sq, int d, int bs, int bs_log, int max_blocks, int splits,
                   int decode, float scale, void* stream) {
  // the tiles, or the combine's weights, whichever is larger
  const size_t smem = std::max(Layout<DP>::kBytes, kRows * (splits + 1) * sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      paged_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * hkv * ((g * sq + kRows - 1) / kRows), splits);
  paged_mma_kernel<DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int32_t*>(block_table),
      static_cast<const int32_t*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), hkv, g, sq, d, bs, bs_log,
      max_blocks, decode, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// Every entry returns the CUDA error of its launch (cudaGetLastError(), 0
// on success); the Python wrapper raises on anything else.  decode: 1 for
// decode (lens = kv_len, sq = 1), 0 for the prefill (lens = q_start).

// fp32 decode and prefill on CUDA cores (route simt): one block per (b, kv
// head, 64-row tile), every key tile in one block.
extern "C" int repro_paged_attention_simt(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lens, void* out, int batch, int hkv,
    int g, int sq, int d, int bs, int max_blocks, int decode, float scale,
    void* stream) {
  if (decode && sq != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(q, k_pool, v_pool, block_table, lens, out,
                                 batch, hkv, g, sq, d, bs, max_blocks, scale,
                                 decode ? 0 : 1, stream));
}

// bf16 decode and prefill on tensor cores (route mma).  dp: the head dim
// the kernel is built for, 16, 32, 64 or 128, at least d.  splits: key
// splits a row tile (1 .. 64).  With splits > 1, part holds batch * hkv *
// row_tiles * splits * 64 * (dp + 2) floats (row_tiles = ceil(g * sq / 64))
// and counters batch * hkv * row_tiles ints, all 0 before the first launch
// (each launch leaves them 0); launches that share them must run in order
// (one stream).
extern "C" int repro_paged_attention_mma(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_table, const void* lens, void* out, void* part,
    void* counters, int batch, int hkv, int g, int sq, int d, int dp, int bs,
    int max_blocks, int splits, int decode, float scale, void* stream) {
  if (batch == 0 || hkv == 0) return 0;
  int bs_log = 0;
  while (bs_log < 30 && (1 << bs_log) < bs) ++bs_log;
  if ((1 << bs_log) != bs) bs_log = -1;       // not a power of two: divide
  const long long units = static_cast<long long>(batch) * hkv *
                          ((static_cast<long long>(g) * sq + tc::kRows - 1) / tc::kRows);
  if (d <= 0 || d % 8 || d > dp || g <= 0 || sq <= 0 || bs <= 0 ||
      max_blocks < 0 || splits < 1 || splits > tc::kMaxSplits ||
      units > 0x7fffffff || (decode && sq != 1) ||
      static_cast<long long>(max_blocks) * bs > 0x7fffffff ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dp) {
#define REPRO_LAUNCH(DP)                                                        \
  case DP:                                                                      \
    return static_cast<int>(tc::launch<DP>(q, k_pool, v_pool, block_table,      \
                                           lens, out, part, counters, batch,    \
                                           hkv, g, sq, d, bs, bs_log,           \
                                           max_blocks, splits, decode, scale,   \
                                           stream))
    REPRO_LAUNCH(16);
    REPRO_LAUNCH(32);
    REPRO_LAUNCH(64);
    REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
