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
// tile and the last query tile are cut at Sk and Sq.  Training asks the
// same launch for each row's log-sum-exp, m + log(max(l, 1e-30)) in
// natural units, into an fp32 (B, Hq, Sq) array (what the reference's
// custom-VJP forward, _flash_fwd_impl, keeps for its backward); serving
// passes a null pointer and nothing more is stored, so out is the same
// bits either way.
//
// What bounds it on the H100: at the serving paths' shapes (B = 1, Hq 16,
// Hkv 8, D 128, S <= 1024, causal) bytes and operations come out about even
// (S = 900: 11 MB of q / k / v / out, 3.3 GFLOP; both about 3.3 us), so
// either kernel is held by how fast it issues its math, not by HBM.  Two
// routes, picked by dtype (flash_attention.route):
//
// bf16, the served dtype: tensor cores (mma.sync m16n8k16, fp32 sums),
// FlashAttention-2's layout.
//   * one block per (64 query rows, b, q-head); each of its four warps owns
//     16 rows.  The g q-heads of a kv head read its K/V from L2 (3.7 MB at
//     S = 900); blocks of 64 rows keep B = 1, S = 900 at 15 x 16 = 240
//     blocks for 132 SMs, two blocks an SM at D = 128 (87 KB of shared
//     memory, 233 registers), three up to D = 64 (registers capped to fit).  The grid starts with the last q tiles, which
//     see the most keys under the causal mask, so the tail wave is short;
//   * q is loaded once into registers as A fragments (ldmatrix); K and V
//     tiles of 64 keys come through shared memory (cp.async, 16 bytes a
//     thread; a thread copies one fixed column with pointers set up once,
//     so a copy is a few instructions), rows padded by 16 bytes so
//     ldmatrix has no bank conflicts; V is read with ldmatrix.trans as the
//     B operand of p v;
//   * K runs one tile ahead of V (two slots each): while tile t's softmax
//     and p v run, q k^T of tile t + 1 is issued in the same straight-line
//     code, so the tensor cores work under the exponentials; one barrier a
//     tile, the next copy overlapping the tile's math;
//   * the online softmax runs on the accumulator fragments in registers, a
//     row's max and sum by two shuffles inside its quad; p becomes the A
//     fragments of p v in registers (the m16n8 C layout is the m16n8k16 A
//     layout), rounded to bf16 (2^-9 relative), while l sums the fp32 p.
//     Logits are kept in log2 units (scale log2 e folded into one multiply,
//     ex2.approx.ftz on the special-function unit); the mask is set after
//     the scaling and only on tiles that cross the causal diagonal, the
//     window's edge or Sk: the tile's math is compiled twice, with and
//     without the mask, and picked once a tile (a branch per element, even
//     one never taken, kept ptxas from interleaving the softmax with the
//     products);
//   * head dims 16, 32, 64 and 128 are templates; a d between them is
//     zero-padded in shared memory (zero columns add nothing to q k^T; the
//     extra columns of o are not stored);
//   * no split over the keys and no atomics: a row's output depends only on
//     its q and on k / v, never on B or on which block holds it (the hybrid
//     path's row-by-row prefill and full-width replay rely on this).
// What holds it (PERF.md section 6): the critical path of the longest q tile,
// 15 key tiles at S = 900 walked one after another by its four warps, each
// tile's exponentials (the special-function unit's rate) and ldmatrix
// reads of K and V (16 rows a warp: every warp reads each tile whole).
//
// fp32: CUDA cores (the fp32 paged == dense identity on the card rests on
// these sums, and TF32 would not hold fp32's tolerance).
//   * one thread block per (q tile, b, kv head) serves all g q-heads that
//     share the kv head: rows = g * bq (at most 64) query rows, so a K/V tile
//     is read from HBM once per kv head and q tile, not once per q-head.  A
//     group of more than 64 is cut into ceil(g / 64) blocks of at most 64
//     q-heads (bq = 1), each reading the kv head's tiles;
//   * K and V go through shared memory in tiles of 64 keys, the next tile
//     copied (cp.async, 16 bytes a thread) while the current one is computed;
//   * key tiles wholly outside the causal / window band of every row of the
//     q tile are skipped (see below for the one exception);
//   * scores: one thread per (key, row group), 8 head-dim elements per
//     16-byte shared load of K, q broadcast from shared memory; PV: one
//     thread per head-dim column holds every row's accumulator in registers;
//     an fp32 online softmax runs between the two (a warp per row).
// What holds it: the CUDA cores' FMA issue rate and the scores' round trip
// through shared memory; the same design took 1.29 ms in bf16 at S = 900,
// 390x the bound, before the bf16 route had its own kernel (PERF.md section 6).
// Its fp32 time is not measured.
// Not done yet: wgmma with K / V read by the tensor cores from shared
// memory and warpgroups taking turns at the softmax (FlashAttention-3), TMA
// for the copies, a split over the keys for short q with long K/V (not
// deterministic across B unless fixed by shape); tensor cores for fp32.
// (32 rows a warp, FlashAttention-2's 128-row blocks, and 8 warps of 16
// rows were tried and were slower at the served shapes: PERF.md section 6.)
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
//     not even to a fully masked row (the bf16 route zero-fills their rows
//     in shared memory and gives them the logit -inf, so p = 0).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;                      // keys per tile
constexpr int kRowGroups = kThreads / kTileKeys;   // score rows split 2 ways
constexpr int kMaxRows = 64;                       // g * bq rows a block
constexpr int kMaxHeadDim = kThreads;              // one PV column a thread
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// eight consecutive elements from 16-byte-aligned shared memory, as floats
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
template <typename T> __host__ __device__ constexpr int row_stride(int d) {
  return d + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ size_t smem_bytes(int rows, int d) {
  return 2 * 2 * static_cast<size_t>(kTileKeys) * row_stride<T>(d) * sizeof(T) +
         (static_cast<size_t>(rows) * d + static_cast<size_t>(rows) * kTileKeys +
          3 * static_cast<size_t>(rows)) * sizeof(float);
}

// Grid: (q tiles, B * Hkv * gblocks); blockIdx.y = (b * hkv + h) * gblocks +
// gb, gblocks = ceil(g / gh).  q / out: (B, hkv * g, sq, d) contiguous; k / v:
// (B, hkv, sk, d) contiguous.  Block gb serves q-heads gb * gh + [0, gn) of
// kv head h, gn = min(gh, g - gb * gh); its row r is q-head h * g + gb * gh +
// r / bq at query q0 + r % bq.  RPT: score rows per thread; gh * bq <=
// kRowGroups * RPT.
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int hkv, int g, int gh,
                       int sq, int sk, int d, int bq, float scale, int causal,
                       int window) {
  constexpr int kRowsMax = kRowGroups * RPT;
  const int gblocks = (g + gh - 1) / gh;
  const int bkv = blockIdx.y / gblocks, gb = blockIdx.y % gblocks;
  const int b = bkv / hkv;
  const int h = bkv % hkv;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, sq - q0);          // queries of this tile
  const int rows = min(gh, g - gb * gh) * bq;
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

  const int64_t head0 = static_cast<int64_t>(b) * hkv * g + static_cast<int64_t>(h) * g +
                        static_cast<int64_t>(gb) * gh;
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
  // the row's log-sum-exp for a backward pass, as _flash_fwd_impl keeps it
  if (lse != nullptr) {
    for (int r = tid; r < rows; r += kThreads)
      if (r % bq < nq)
        lse[row_offset(r) / d] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int RPT>
cudaError_t launch_rpt(const void* q, const void* k, const void* v, void* out,
                       float* lse, int batch, int hkv, int g, int gh, int sq, int sk,
                       int d, int bq, float scale, int causal, int window,
                       void* stream) {
  const size_t smem = smem_bytes<T>(gh * bq, d);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + bq - 1) / bq, batch * hkv * ((g + gh - 1) / gh));
  flash_attention_kernel<T, RPT><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, hkv, g, gh, sq, sk,
      d, bq, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int hkv, int g, int sq, int sk,
                   int d, float scale, int causal, int window, void* stream) {
  if (batch == 0 || hkv == 0 || sq == 0) return cudaSuccess;
  if (d % 8 || d > kMaxHeadDim || g <= 0 || sk <= 0 ||
      static_cast<long long>(batch) * hkv * ((g + kMaxRows - 1) / kMaxRows) > 65535)
    return cudaErrorInvalidValue;
  const int gh = std::min(g, kMaxRows);        // q-heads a block
  const int bq = std::min(kMaxRows / gh, sq);  // queries a block, gh * bq rows
  const int rows = gh * bq;
#define REPRO_LAUNCH(RPT)                                                  \
  return launch_rpt<T, RPT>(q, k, v, out, lse, batch, hkv, g, gh, sq, sk, \
                            d, bq, scale, causal, window, stream)
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
// bf16 on tensor cores (mma.sync m16n8k16, fp32 accumulators).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;     // four warps
constexpr int kRows = 64;         // query rows a block, 16 a warp
constexpr int kKeys = 64;         // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared rows of DP bf16 padded by 16 bytes: the eight 16-byte row reads of
// an ldmatrix then fall in eight distinct bank groups for every DP.
// Blocks an SM must hold: three up to D = 64 (480 blocks of zamba2's
// shape then take 1.2 waves, not 1.8), two at D = 128 (shared memory
// allows no more); ptxas caps the registers to fit.
template <int DP> constexpr int kMinBlocks = DP <= 64 ? 3 : 2;

template <int DP> struct Layout {
  static constexpr int kLd = DP + 8;
  static constexpr int kTile = kRows * kLd;          // elements of a tile
  static constexpr size_t kBytes = 5 * kTile * sizeof(bf16);  // Q, K[2], V[2]
};

// The key range [begin, end) that query positions [qpos_first, qpos_last]
// can see (see the header: a range holding a row with no valid key walks
// every key).
__device__ __forceinline__ void key_band(int qpos_first, int qpos_last, int sk,
                                         int causal, int window, int& begin,
                                         int& end) {
  begin = 0;
  end = sk;
  if (causal && qpos_first < 0) return;
  if (window > 0) begin = max(0, qpos_first - window + 1);
  if (causal) end = min(sk, qpos_last + 1);
}

// Grid: (B * Hq, q tiles), the last q tile first (under the causal mask it
// sees the most keys, so the longest blocks start in the first wave).  q /
// out: (B, Hq, sq, d), k / v: (B, Hq / g, sk, d), all contiguous.  DP: the
// head dim the tensor cores see, the template at or above d (the columns
// d .. DP-1 are zeros in shared memory and never stored).
//
// The key tiles [t_begin, t_end) of the block's band are walked with K one
// tile ahead of V: while tile t's softmax and p v run, q k^T of tile t + 1
// is issued in the same straight-line code, so the tensor cores work under
// the exponentials.  Shared memory holds Q, two K slots and two V slots;
// copy group t brings K of tile t + 1 and V of tile t.
template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int hq, int g, int sq, int sk, int d,
                 float scale_log2, int causal, int window) {
  using L = Layout<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kKSteps = DP / 16;     // k16 steps of q k^T
  constexpr int kDTiles = DP / 8;      // n8 tiles of o
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / g;
  const int hkv = hq / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nq = min(kRows, sq - q0);
  const int shift = sk - sq;            // qpos = query index + shift
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, quad = lane & 3;   // fragment row, column pair

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
  // 8) of rows t / (DP / 8) + i (128 / (DP / 8)); a padded column (>= d /
  // 8) is left as it is, and a row at or past the matrix's end is
  // zero-filled, not read.  The loop has a fixed trip count and the
  // pointers are set up once, so a copy costs a few instructions.
  constexpr int kChunks = DP / 8, kRowStep = kThreads / kChunks;
  constexpr int kCopies = kRows / kRowStep;
  const int my_ch = tid % kChunks, my_row = tid / kChunks;
  const bool copies = my_ch < vec;
  const int64_t step = static_cast<int64_t>(kRowStep) * d;   // elements
  const int64_t q_base = static_cast<int64_t>(bh) * sq * d;
  const int64_t kv_base = (static_cast<int64_t>(b) * hkv + kvh) * sk * d;
  const int64_t my_off = static_cast<int64_t>(my_row) * d + my_ch * 8;
  const uint32_t my_smem = (my_row * kLd + my_ch * 8) * sizeof(bf16);
  const uint32_t q_smem = smem_u32(q_s) + my_smem;
  const uint32_t k_smem = smem_u32(k_s) + my_smem;
  const uint32_t v_smem = smem_u32(v_s) + my_smem;
  const bf16* k_src = k + kv_base + my_off;
  const bf16* v_src = v + kv_base + my_off;

  int k_begin, k_end;                  // the block's band
  key_band(q0 + shift, q0 + nq - 1 + shift, sk, causal, window, k_begin, k_end);
  const int t_begin = k_begin / kKeys;
  const int t_end = (k_end + kKeys - 1) / kKeys;
  // A warp walks every tile of its block's band (a tile outside its own
  // rows' band takes the masked path, which leaves a row with a valid key
  // as it was, as the header's note on skipped tiles says); a warp with no
  // real row does no math.
  const bool w_active = warp * 16 < nq;
  const int wq_first = q0 + warp * 16 + shift;
  const int wq_last = wq_first + min(16, nq - warp * 16) - 1;

  // rows tile * 64 .. + 63 of k or v into slot `slot` (nothing past t_end)
  auto copy_tile = [&](uint32_t smem, const bf16* src, const bf16* base,
                       int tile, int slot) {
    if (!copies || tile >= t_end) return;
    const int rows_left = sk - tile * kKeys - my_row;
    const int64_t off = static_cast<int64_t>(tile) * kKeys * d;
    const uint32_t so = slot * L::kTile * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool ok = i * kRowStep < rows_left;
      cp_async16(smem + so + i * kRowStep * kLd * sizeof(bf16),
                 ok ? src + off + i * step : base, ok);
    }
  };
  if (copies) {
    const int rows_left = sq - q0 - my_row;
    const bf16* q_src = q + q_base + static_cast<int64_t>(q0) * d + my_off;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const bool ok = i * kRowStep < rows_left;
      cp_async16(q_smem + i * kRowStep * kLd * sizeof(bf16),
                 ok ? q_src + i * step : q, ok);
    }
  }
  copy_tile(k_smem, k_src, k, t_begin, 0);           // Q and K of t_begin
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  copy_tile(k_smem, k_src, k, t_begin + 1, 1);       // group t_begin
  copy_tile(v_smem, v_src, v, t_begin, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  uint32_t qf[kKSteps][4];             // this warp's 16 query rows, A fragments
#pragma unroll
  for (int kd = 0; kd < kKSteps; ++kd)
    ldsm_x4(qf[kd], smem_u32(q_s + (warp * 16 + (lane & 15)) * kLd + kd * 16 +
                             (lane >> 4) * 8));
  // s = q k^T of one K slot: 16 rows x 64 keys, eight n8 tiles
  auto qk = [&](float (&s)[8][4], const bf16* k_t) {
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
  };
  float s[8][4];                       // scores of the current tile
  if (w_active) qk(s, k_s);
  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows gid and gid + 8, log2 units
  float l_r[2] = {0.f, 0.f};           // this thread's share of each row sum

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int i = tile - t_begin;
    // group i (K of tile + 1, V of tile) has landed, and every warp is done
    // with tile - 1, whose K slot and V slot the next group refills
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    copy_tile(k_smem, k_src, k, tile + 2, i & 1);
    copy_tile(v_smem, v_src, v, tile + 1, (i + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int k0 = tile * kKeys;
    const bf16* k_next = k_s + ((i + 1) & 1) * L::kTile;   // stale past t_end
    const bf16* v_t = v_s + (i & 1) * L::kTile;
    // the tile's math, compiled twice: with the mask (a tile that crosses
    // the causal diagonal, the window's edge or sk) and without.  One
    // branch a tile; inside, straight-line code the compiler can
    // interleave (a branch inside keeps it from that, even when not taken)
    auto tile_math = [&](auto masked_tile) {
      constexpr bool kMask = decltype(masked_tile)::value;
      float sn[8][4];
      qk(sn, k_next);                  // the next tile's scores, issued first
      // logits in log2 units; the mask only where the tile crosses the
      // causal diagonal, the window's edge or sk (masked: -1e30 after the
      // scaling, as the reference; past sk: -inf, p = 0)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      if constexpr (kMask) {
        const int qpos0 = q0 + warp * 16 + gid + shift;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + quad * 2 + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            const bool masked = (causal && key > qpos) ||
                                (window > 0 && key <= qpos - window);
            s[j][e] = key >= sk ? -INFINITY : masked ? kNegInf : s[j][e];
          }
        }
      }
      // online softmax on the fragments: a row lives in the four threads
      // of a quad
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
      uint32_t pa[4][4];                  // p as A fragments, 16 keys each
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - mx[e >> 1]);
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
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sn[j][e];
    };
    if (w_active) {
      if (k0 + kKeys > sk || (causal && k0 + kKeys - 1 > wq_first) ||
          (window > 0 && k0 <= wq_last - window))
        tile_math(std::true_type{});
      else
        tile_math(std::false_type{});
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    // the row's log-sum-exp for a backward pass (m_r is in log2 units), as
    // _flash_fwd_impl keeps it; one thread of the quad stores it
    const int row = warp * 16 + gid + i * 8;
    if (lse != nullptr && quad == 0 && row < nq)
      lse[static_cast<int64_t>(bh) * sq + q0 + row] =
          m_r[i] * 0.6931471805599453f + logf(fmaxf(l_r[i], 1e-30f));
    if (l_r[i] == 0.f) l_r[i] = 1.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + gid + i * 8;
    if (row >= nq) continue;
    bf16* dst = out + q_base + static_cast<int64_t>(q0 + row) * d;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const int col = j * 8 + quad * 2;
      if (j * 8 < d)
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(o[j][2 * i] / l_r[i], o[j][2 * i + 1] / l_r[i]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int hkv, int g, int sq, int sk,
                   int d, float scale, int causal, int window, void* stream) {
  const size_t smem = Layout<DP>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * hkv * g, (sq + kRows - 1) / kRows);
  flash_mma_kernel<DP><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, hkv * g, g,
      sq, sk, d, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

}  // namespace tc

// The fp32 route (CUDA cores).  dtype: 0 = float32, the only type this
// route takes (bf16: repro_flash_attention_mma).  lse: null, or an fp32
// (B, Hq, Sq) array that takes each row's log-sum-exp m + log(max(l,
// 1e-30)) in natural units (the training path's backward reads it; serving
// passes null and nothing is stored).  causal: 0 or 1; window <= 0: none.
// Returns the CUDA error of the launch (cudaGetLastError(), 0 on success);
// the Python wrapper raises on anything else.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int batch, int hkv, int g, int sq, int sk,
                                     int d, float scale, int causal,
                                     int window, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<float>(q, k, v, out, static_cast<float*>(lse),
                                        batch, hkv, g, sq, sk, d, scale,
                                        causal, window, stream));
}

// The bf16 route (tensor cores).  dp: the head dim the kernel is built for,
// 16, 32, 64 or 128, at least d (the wrapper's flash_attention.route picks
// the least such).  Same arguments and return otherwise.
extern "C" int repro_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int batch, int hkv, int g, int sq,
                                         int sk, int d, int dp, float scale,
                                         int causal, int window,
                                         void* stream) {
  if (batch == 0 || hkv == 0 || sq == 0) return 0;
  if (d <= 0 || d % 8 || d > dp || g <= 0 || sk <= 0 ||
      (sq + tc::kRows - 1) / tc::kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dp) {
#define REPRO_LAUNCH(DP)                                                    \
  case DP:                                                                  \
    return static_cast<int>(tc::launch<DP>(q, k, v, out,                  \
                                           static_cast<float*>(lse), batch, \
                                           hkv, g, sq, sk, d, scale,        \
                                           causal, window, stream))
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
