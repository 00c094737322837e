// Forward sampler, study variant v6, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v6`
// (launched by `_fwd_like_v0` through `fwd_v6`). It computes the sampler's
// function with v6's arithmetic: only the x weights are rounded to the
// value dtype; everything after is f32:
//
//   wx = (1 - tx)*a and tx*a, rounded to the value dtype (one-hot form)
//   out = sum over levels, points and corners of wx*wy*v in f32, wy = 1 - ty
//         or ty, rounded once.
//
// `_kernel_v6`'s lever is the point sum before the y-sum: on the TPU it
// moves the narrow y-sum product from TQ*P rows to TQ. A gather has no
// counterpart of that lever: its y-sum is two multiply-adds a point. So
// this kernel is the main-path kernel's arithmetic with v6's one rounding
// point, and its time says what that rounding costs, not what the
// reassociation saves.
//
// What bounds it on the card: bytes (the corner rows, as the main-path
// kernel), and before them the loads a warp keeps in flight. The TPU's
// grid (a block of all heads per (batch, query tile): 10 blocks at Q=600
// on 132 SMs, two elements a lane) was what the card paid for. The design
// is the main-path kernel's (`ms_deform_attn_fwd.cu`), shared with v1 and
// v45 (`walk_points` in sampler_common.cuh):
//
// - the grid: one warp per (b, q, h), on the native [B,S,H,D] value, loc
//   and attn, writing [B,Q,H*D] directly (4,800 warps at Q=600);
// - the warp: the flat loop over the L*P points, one point at a time in
//   each of 32/G sub-groups of G lanes, which load its four corner rows in
//   16-byte pieces (`load_corners`, `Piece<T, true>`); each lane sums its
//   piece's corners times their weight in f32, and a shuffle reduction
//   joins the sub-groups;
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

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]; the grid and warp of `walk_points`.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARP_GRID_THREADS)
    fwd_v6_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  constexpr int N = Piece<T, VEC>::N, K = row_pieces(VEC);
  walk_points<T, VEC>(
      value, loc, attn, out, S, Q, H, D, L, P, G, n_warps, lv,
      [&](const Corners& cn, float, float, float a,
          const float (&v)[4][K][N], float (&acc)[K][N]) {
        // the x weights with attn, rounded to the value dtype (v6's one
        // rounding point); 0 outside
        const float wx[2] = {round_to<T>(__fmul_rn(1.f - cn.tx, a)),
                             round_to<T>(__fmul_rn(cn.tx, a))};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float w = cn.ok[c] ? wx[c & 1] * cn.wy(c) : 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int n = 0; n < N; ++n) acc[k][n] += w * v[c][k][n];
        }
      });
}

template <typename T, bool VEC>
struct FwdV6 {
  static WarpGridKernel<T> fn() { return fwd_v6_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v6(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  return warp_grid_entry<FwdV6>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                L, P, TQ, hw, stream);
}
