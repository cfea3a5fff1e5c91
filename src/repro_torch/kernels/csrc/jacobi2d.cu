// One 5-point Jacobi sweep, written for Hopper (sm_90a).
//
// Replaces jacobi2d_pallas (src/repro/kernels/jacobi2d.py:26, kernel body
// _jacobi_kernel at lines 16-22): y = x with every interior point (not on
// the first or last row or column) replaced by
//   0.2 * ((((centre + up) + down) + left) + right)
// in x's type (fp32 or bf16).  In bf16 each add and the product round to
// bf16 and 0.2 is bf16's 0.2001953125, as the reference's weakly typed
// scalar computes; here as packed bf16x2 adds and multiplies (add.rn /
// mul.rn.bf16x2), each correctly rounded, which is what an fp32 add or
// product of two bf16 values rounded to bf16 gives (fp32 carries more than
// twice bf16's 8 bits, so the double rounding is innocuous).  In fp32 the
// adds and the product are single fp32 operations that cannot contract (no
// multiply feeds an add).  So the result equals the plain version and the
// reference bit for bit.  Any H and W (the Pallas kernel asserts that its
// 8-row blocks divide H - 2); with H or W below 3 the sweep is a copy.
//
// What bounds it on the H100: bytes.  At 16384^2 fp32 one sweep reads 1.07
// GB and writes 1.07 GB, 0.641 ms at 3.35 TB/s, against 1.3 G operations
// (4 adds and a multiply a point).  What the design does:
//   * a thread owns 16 bytes of a row, 4 fp32 or 8 bf16 columns, and moves
//     them by one 16-byte load and store where the row is 16-byte aligned
//     and the vector inside [0, W) (element by element where not: W not a
//     multiple of 4 or 8, the tail of a row);
//   * a block of 128 threads walks a strip of kRows rows down a column
//     strip of 512 (fp32) or 1024 (bf16) columns, the rows above, at and
//     below the one it computes in a register ring that rolls as it goes,
//     so each row is read from memory once, plus one halo row at each end
//     of the strip; kAhead = 6 rows are loaded ahead of the one computed,
//     ~60 KB an SM in flight (~90 registers a thread, 5 blocks an SM);
//   * left and right neighbours come from the adjacent lanes by __shfl; a
//     warp's two edge elements by a scalar load that L1 / L2 serve;
//   * one C call launches every sweep of a call, ping-ponging two buffers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;              // rows a block walks down its strip
constexpr int kAhead = 6;              // rows loaded ahead of the one computed
constexpr int kRing = kAhead + 2;      // those, and the rows above and at it
constexpr unsigned kFull = 0xffffffffu;

// A thread's 16 bytes of one row and, for lanes 0 and 31, the element just
// left / right of the warp's columns (bits, in the low end of the word).
struct Row {
  uint4 v;
  unsigned le, re;
};

// U: the element's bits, unsigned (fp32) or unsigned short (bf16)
template <typename U>
__device__ __forceinline__ uint4 pack(const U* e) {
  if constexpr (sizeof(U) == 4) return make_uint4(e[0], e[1], e[2], e[3]);
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = static_cast<unsigned>(e[2 * j]) |
           (static_cast<unsigned>(e[2 * j + 1]) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename U>
__device__ __forceinline__ U element(uint4 v, int k) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(U) == 4) return u[k];
  return static_cast<U>(k & 1 ? u[k / 2] >> 16 : u[k / 2] & 0xffffu);
}

template <typename U>
__device__ __forceinline__ bool aligned(const U* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// This thread's part of row r (columns c0 .. c0 + V - 1, those < w) and
// its warp's edge elements; nothing at or past column w is read.
template <typename U>
__device__ __forceinline__ void load_row(const U* __restrict__ x, int r,
                                         int w, long long c0, int lane,
                                         Row& row) {
  constexpr int V = 16 / sizeof(U);
  const U* xr = x + static_cast<size_t>(r) * w;
  if (c0 + V <= w && aligned(xr + c0)) {
    row.v = __ldg(reinterpret_cast<const uint4*>(xr + c0));
  } else if (c0 < w) {
    U e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = c0 + k < w ? __ldg(xr + c0 + k) : U(0);
    row.v = pack(e);
  }
  if (lane == 0 && c0 > 0 && c0 <= w) row.le = __ldg(xr + c0 - 1);
  if (lane == 31 && c0 + V < w) row.re = __ldg(xr + c0 + V);
}

template <typename U>
__device__ __forceinline__ void store_row(U* __restrict__ y, int r, int w,
                                          long long c0, uint4 v) {
  constexpr int V = 16 / sizeof(U);
  U* yr = y + static_cast<size_t>(r) * w;
  if (c0 + V <= w && aligned(yr + c0)) {
    *reinterpret_cast<uint4*>(yr + c0) = v;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (c0 + k < w) yr[c0 + k] = element<U>(v, k);
  }
}

__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The stencil on this thread's columns of an interior row, every column
// (the caller restores columns 0 and w - 1).  fp32:
__device__ __forceinline__ uint4 stencil(unsigned, const Row& up,
                                         const Row& cur, const Row& dn,
                                         int lane) {
  const unsigned cw[4] = {cur.v.x, cur.v.y, cur.v.z, cur.v.w};
  const unsigned uw[4] = {up.v.x, up.v.y, up.v.z, up.v.w};
  const unsigned dw[4] = {dn.v.x, dn.v.y, dn.v.z, dn.v.w};
  unsigned lw = __shfl_up_sync(kFull, cw[3], 1);
  unsigned rw = __shfl_down_sync(kFull, cw[0], 1);
  if (lane == 0) lw = cur.le;
  if (lane == 31) rw = cur.re;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float l = __uint_as_float(k > 0 ? cw[k - 1] : lw);
    const float r = __uint_as_float(k < 3 ? cw[k + 1] : rw);
    float s = __fadd_rn(__uint_as_float(cw[k]), __uint_as_float(uw[k]));
    s = __fadd_rn(__fadd_rn(__fadd_rn(s, __uint_as_float(dw[k])), l), r);
    o[k] = __fmul_rn(0.2f, s);
  }
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                    __float_as_uint(o[2]), __float_as_uint(o[3]));
}

// bf16: pairs of columns in each word; the left pairs (c[2j-1], c[2j]) and
// right pairs (c[2j+1], c[2j+2]) are byte permutes of neighbouring words
__device__ __forceinline__ uint4 stencil(unsigned short, const Row& up,
                                         const Row& cur, const Row& dn,
                                         int lane) {
  const unsigned cw[4] = {cur.v.x, cur.v.y, cur.v.z, cur.v.w};
  const unsigned uw[4] = {up.v.x, up.v.y, up.v.z, up.v.w};
  const unsigned dw[4] = {dn.v.x, dn.v.y, dn.v.z, dn.v.w};
  unsigned lw = __shfl_up_sync(kFull, cw[3], 1);   // its high half
  unsigned rw = __shfl_down_sync(kFull, cw[0], 1);  // its low half
  if (lane == 0) lw = cur.le << 16;
  if (lane == 31) rw = cur.re;
  // bf16(0.2f) = 0x3e4d, 0.2001953125, in both halves
  constexpr unsigned kFifth = 0x3e4d3e4du;
  unsigned o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned l = __byte_perm(j > 0 ? cw[j - 1] : lw, cw[j], 0x5432);
    const unsigned r = __byte_perm(cw[j], j < 3 ? cw[j + 1] : rw, 0x5432);
    unsigned s = add_bf16x2(cw[j], uw[j]);
    s = add_bf16x2(add_bf16x2(add_bf16x2(s, dw[j]), l), r);
    o[j] = mul_bf16x2(kFifth, s);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Element k of v replaced by element k of c, for the columns 0 and w - 1
template <typename U>
__device__ __forceinline__ uint4 keep_edges(uint4 v, uint4 c, long long c0,
                                            int w) {
  constexpr int V = 16 / sizeof(U);
  U e[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    e[k] = (c0 + k == 0 || c0 + k == w - 1) ? element<U>(c, k)
                                             : element<U>(v, k);
  return pack(e);
}

// blockIdx.x: the column strip; blockIdx.y walks the row strips
template <typename U>
__global__ void __launch_bounds__(kThreads)
jacobi2d_kernel(const U* __restrict__ x, U* __restrict__ y, int h, int w) {
  constexpr int V = 16 / sizeof(U);
  const int lane = threadIdx.x & 31;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  const bool edge_cols = c0 == 0 || (c0 < w && c0 + V >= w);
  const int strips = (h + kRows - 1) / kRows;
  for (int t = blockIdx.y; t < strips; t += gridDim.y) {
    const int ra = t * kRows;
    const int rb = min(ra + kRows, h);      // rows ra .. rb - 1
    const int last = min(rb, h - 1);        // the last row read
    Row ring[kRing];                        // row ra - 1 + s in slot s
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      ring[s] = Row{make_uint4(0, 0, 0, 0), 0, 0};
      const int r = ra - 1 + s;
      if (r >= 0 && r <= last) load_row(x, r, w, c0, lane, ring[s]);
    }
    for (int base = ra; base < rb; base += kRing) {
#pragma unroll
      for (int s = 0; s < kRing; ++s) {
        const int r = base + s;
        if (r >= rb) break;                 // uniform across the block
        const Row& cur = ring[(s + 1) % kRing];
        uint4 o = cur.v;
        if (r > 0 && r < h - 1) {
          o = stencil(U(0), ring[s], cur, ring[(s + 2) % kRing], lane);
          if (edge_cols) o = keep_edges<U>(o, cur.v, c0, w);
        }
        if (c0 < w) store_row(y, r, w, c0, o);
        // row r - 1's slot takes row r + kAhead + 1
        if (r + kAhead + 1 <= last)
          load_row(x, r + kAhead + 1, w, c0, lane, ring[s]);
      }
    }
  }
}

template <typename U>
cudaError_t run(const void* x, void* out, void* scratch, int h, int w,
                int steps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(U);
  const long long cols = (static_cast<long long>(w) + kThreads * V - 1) /
                         (kThreads * V);
  const int strips = (h + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(cols), strips < 65535 ? strips : 65535);
  const U* src = static_cast<const U*>(x);
  for (int i = 0; i < steps; ++i) {
    U* dst = static_cast<U*>((steps - 1 - i) % 2 == 0 ? out : scratch);
    jacobi2d_kernel<U><<<grid, kThreads, 0, stream>>>(src, dst, h, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// `steps` >= 1 sweeps of x (h, w) into out (h, w), through scratch (h, w)
// when steps > 1; all contiguous, none overlapping; dtype (x, out,
// scratch): 0 = float32, 1 = bfloat16; h, w >= 1.  Returns the CUDA error
// of the first launch that failed (0 on success); the Python wrapper raises
// on anything else.
extern "C" int repro_jacobi2d(int dtype, const void* x, void* out,
                              void* scratch, int h, int w, int steps,
                              void* stream) {
  if (h < 1 || w < 1 || steps < 1 || (steps > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(run<unsigned>(x, out, scratch, h, w, steps, s));
    case 1:
      return static_cast<int>(
          run<unsigned short>(x, out, scratch, h, w, steps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
