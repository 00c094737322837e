// Forward sampler, study variant v3, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v3`
// (launched by `fwd_v3`). It computes the sampler's function with what v3
// studies: the levels fused into one pass. The TPU kernel stacks the levels
// into one block-diagonal table so that a (head, query tile) issues one
// product, with per-level guards so that no tap leaks into a neighbouring
// level, and folds the attention weight into the x weight ((1 - tx) * a or
// tx * a) before the y weight. Here there is no table: one flat loop covers
// the L*P points of a (q, h), each point looks up its level's bounds and
// offset, and the guards are the bounds test. Per corner c the weight is
//
//   w = (wx(c) * a) * wy(c),   wx = 1 - tx or tx, wy = 1 - ty or ty,
//
// in f32, in the TPU kernel's order, and acc += w * v; sums are f32 and the
// output is rounded once.
//
// What bounds it on the card: bytes (the corner rows, as the main-path
// kernel), and before them the loads a warp keeps in flight. The TPU's
// grid (a 1024-thread block per (batch, query tile) holding all heads: 10
// blocks at Q=600 on 132 SMs, the tile's loc and attn staged into 73.7 KB
// of shared memory, one tap at a time) was what the card paid for. So the
// design is the main-path kernel's (`ms_deform_attn_fwd.cu`) with v3's
// arithmetic, shared with v1, v2, v45 and v6 (`walk_points` in
// sampler_common.cuh):
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
//   indices (`level_at`); nothing is staged in shared memory.
//
// A corner outside its level is loaded as zeros and its weight is zeroed by
// a select, not a branch (branches left spills in the one-element
// instantiations of v45), so a weight that is not finite never meets a
// value. A row that is not a multiple of 16 bytes, or not on a 16-byte
// boundary, takes the same kernel with one element a lane piece
// (`Piece<T, false>`). TQ, the study's queries a block, does not tile this
// grid: it is checked and otherwise unused.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]; the grid and warp of `walk_points`.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARP_GRID_THREADS)
    fwd_v3_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  constexpr int N = Piece<T, VEC>::N, K = row_pieces(VEC);
  walk_points<T, VEC>(
      value, loc, attn, out, S, Q, H, D, L, P, G, n_warps, lv,
      [&](const Corners& cn, float, float, float a,
          const float (&v)[4][K][N], float (&acc)[K][N]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // attn folded into the x weight; 0 for a corner outside its level
          const float w = cn.ok[c] ? (cn.wx(c) * a) * cn.wy(c) : 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int n = 0; n < N; ++n) acc[k][n] += w * v[c][k][n];
        }
      });
}

template <typename T, bool VEC>
struct FwdV3 {
  static WarpGridKernel<T> fn() { return fwd_v3_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v3(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  return warp_grid_entry<FwdV3>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                L, P, TQ, hw, stream);
}
