// Forward sampler, study variants v4 and v5, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v45`
// (launched by `_fwd_like_v0` through `fwd_v4`; v4 with `compact_cy`, v5
// without). It computes the sampler's function with what v4/v5 study: the
// intermediates held in the value dtype. Per level and point, at the TPU
// kernel's rounding points:
//
//   wx = (1 - tx)*a and tx*a, rounded to the value dtype (one-hot form)
//   wy = 1 - ty and ty, rounded to the value dtype
//   t  = wx0*v[y, x0] + wx1*v[y, x0+1] in f32, rounded to the value dtype
//   u  = t*wy, a product in the value dtype
//   s  = u(y0) + u(y0+1) in f32, rounded to the value dtype
//   out = sum over levels and points of s in f32, rounded once.
//
// The products are kept apart from the sums (`__fmul_rn`, `__fadd_rn`), so
// nvcc fuses no product into a multiply-add where the TPU rounds between
// them. In bf16 and fp16 u is one `__hmul2` on a pair of the piece's
// elements (correctly rounded, as the TPU's product in bf16), and packing
// t into that pair is its rounding; in f32 u is an f32 product.
//
// v4 builds the y weights compact on the TPU ([R, Hl], expanded by a
// product), v5 at full width: the same values. Here every lane receives a
// point's loc by shuffle and computes its y weights itself, so there is
// nothing left to hand out: `compact_cy` is taken and ignored, and v4 and
// v5 run one code path (their outputs are equal bit for bit).
//
// What bounds it on the card: bytes (the corner rows, as the main-path
// kernel), and before them the loads a warp keeps in flight. The TPU's
// grid (a block of all heads per (batch, query tile): 10 blocks at Q=600
// on 132 SMs, two elements a lane) was what the card paid for. The design
// is the main-path kernel's (`ms_deform_attn_fwd.cu`) with v4's
// arithmetic, shared with v1 and v6 (`walk_points` in sampler_common.cuh):
//
// - the grid: one warp per (b, q, h), on the native [B,S,H,D] value, loc
//   and attn, writing [B,Q,H*D] directly (4,800 warps at Q=600);
// - the warp: the flat loop over the L*P points, one point at a time in
//   each of 32/G sub-groups of G lanes, which load its four corner rows in
//   16-byte pieces (`load_corners`, `Piece<T, true>`); each lane adds its
//   piece's rounded s to an f32 sum, and a shuffle reduction joins the
//   sub-groups (the f32 point and level sums in another order than the
//   plain version's: at most one bf16 ulp of the output apart);
// - loc and attn are loaded once per warp with coalesced loads and handed
//   out by shuffles (`WarpPoints`); the level table is read with constant
//   indices (`level_at`).
//
// A row that is not a multiple of 16 bytes, or not on a 16-byte boundary,
// takes the same kernel with one element a lane piece (`Piece<T, false>`).
// TQ, the study's queries a block, does not tile this grid: it is checked
// and otherwise unused.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

// u[n] = t[n]*w in the value dtype: t and w rounded to it, multiplied
// there, returned as floats. bf16 and fp16 take two elements a `__hmul2`.
template <typename T, int N>
struct NarrowMul;

template <int N>
struct NarrowMul<float, N> {
  static __device__ __forceinline__ void run(const float (&t)[N], float w,
                                             float (&u)[N]) {
#pragma unroll
    for (int n = 0; n < N; ++n) u[n] = __fmul_rn(t[n], w);
  }
};

template <int N>
struct NarrowMul<__nv_bfloat16, N> {
  static __device__ __forceinline__ void run(const float (&t)[N], float w,
                                             float (&u)[N]) {
    if constexpr (N % 2 == 0) {
      const __nv_bfloat162 w2 = __float2bfloat162_rn(w);
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        const float2 p = __bfloat1622float2(
            __hmul2(__floats2bfloat162_rn(t[n], t[n + 1]), w2));
        u[n] = p.x;
        u[n + 1] = p.y;
      }
    } else {
      const __nv_bfloat16 w1 = __float2bfloat16(w);
#pragma unroll
      for (int n = 0; n < N; ++n)
        u[n] = __bfloat162float(__hmul(__float2bfloat16(t[n]), w1));
    }
  }
};

template <int N>
struct NarrowMul<__half, N> {
  static __device__ __forceinline__ void run(const float (&t)[N], float w,
                                             float (&u)[N]) {
    if constexpr (N % 2 == 0) {
      const __half2 w2 = __float2half2_rn(w);
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        const float2 p = __half22float2(
            __hmul2(__floats2half2_rn(t[n], t[n + 1]), w2));
        u[n] = p.x;
        u[n + 1] = p.y;
      }
    } else {
      const __half w1 = __float2half(w);
#pragma unroll
      for (int n = 0; n < N; ++n)
        u[n] = __half2float(__hmul(__float2half(t[n]), w1));
    }
  }
};

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]; the grid and warp of `walk_points`.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARP_GRID_THREADS)
    fwd_v45_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn, T* __restrict__ out, int S,
                   int Q, int H, int D, int L, int P, int G,
                   long long n_warps, Levels lv) {
  constexpr int N = Piece<T, VEC>::N, K = row_pieces(VEC);
  walk_points<T, VEC>(
      value, loc, attn, out, S, Q, H, D, L, P, G, n_warps, lv,
      [&](const Corners& cn, float, float, float a,
          const float (&v)[4][K][N], float (&acc)[K][N]) {
        // the one-hot weights in the value dtype, 0 for a tap outside and
        // for a row with no tap inside (whose corners were loaded as
        // zeros), so a weight that is not finite (loc NaN or inf) never
        // meets a value. Selects, not branches: with branches ptxas kept
        // the one-element instantiations' weights in local memory.
        const float wx0 = round_to<T>(__fmul_rn(1.f - cn.tx, a));
        const float wx1 = round_to<T>(__fmul_rn(cn.tx, a));
        const float wy0 = round_to<T>(1.f - cn.ty), wy1 = round_to<T>(cn.ty);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float s[N];
#pragma unroll
          for (int n = 0; n < N; ++n) s[n] = 0.f;
#pragma unroll
          for (int cy = 0; cy < 2; ++cy) {
            const bool ok0 = cn.ok[2 * cy], ok1 = cn.ok[2 * cy + 1];
            const float w0 = ok0 ? wx0 : 0.f, w1 = ok1 ? wx1 : 0.f;
            const float wy = (ok0 || ok1) ? (cy ? wy1 : wy0) : 0.f;
            float t[N], u[N];
#pragma unroll
            for (int n = 0; n < N; ++n)
              t[n] = __fadd_rn(__fmul_rn(w0, v[2 * cy][k][n]),
                               __fmul_rn(w1, v[2 * cy + 1][k][n]));
            NarrowMul<T, N>::run(t, wy, u);  // t rounded, u = t*wy in T
#pragma unroll
            for (int n = 0; n < N; ++n) s[n] = __fadd_rn(s[n], u[n]);
          }
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[k][n] = __fadd_rn(acc[k][n], round_to<T>(s[n]));
        }
      });
}

template <typename T, bool VEC>
struct FwdV45 {
  static WarpGridKernel<T> fn() { return fwd_v45_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). compact_cy: 1 for
// v4, 0 for v5 (the same values; not used, see above). D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v45(const void* value, const void* loc,
                                      const void* attn, void* out, int dtype,
                                      int B, int S, int Q, int H, int D,
                                      int L, int P, int TQ, int compact_cy,
                                      const int* hw, void* stream) {
  (void)compact_cy;
  return warp_grid_entry<FwdV45>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                 L, P, TQ, hw, stream);
}
