// Forward sampler, study variant v2, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v2`
// (launched by `fwd_v2`). It computes the sampler's function with v1's
// arithmetic (hat weights, the attention weight on the per-point sum, f32
// inside, the output rounded once) and what v2 studies: heads on the grid
// and head-major operands. The wrapper lays value out as [B,H,S,D] and loc
// and attn as [B,H,Q,...]; the output is [B,H,Q,D] and the wrapper
// transposes it back. Those copies are the variant's cost and are timed
// with it; the kernel alone measures what a head-major value gives the
// main-path kernel's grid.
//
// What bounds it on the card: bytes (the corner rows, as v1), and before
// them the loads a warp keeps in flight. The TPU's grid (a 512-thread block
// per (query tile, head, batch): 80 blocks at Q=600, one element a lane)
// was what the card paid for. So the design is v1's
// (`ms_deform_attn_fwd_v1.cu`) on the head-major layout, through the same
// code (`walk_points` with `HEAD_MAJOR`, and the body `HatPoint`, in
// sampler_common.cuh):
//
// - the grid: one warp per (b, h, q) on [B,H,S,D] (4,800 warps at Q=600),
//   whose warp index is also its row of loc, attn and out; in [B,H,S,D] a
//   point's x-neighbours lie D elements apart (64 bytes in bf16 at D=32,
//   against H*D*2 = 512 in [B,S,H,D]);
// - the warp: v1's, the points one at a time in sub-groups that load the
//   four corner rows in 16-byte pieces, loc and attn by shuffles, a shuffle
//   join of the sub-groups and 16-byte stores.
//
// A row that is not a multiple of 16 bytes, or not on a 16-byte boundary,
// takes the same kernel with one element a lane piece (`Piece<T, false>`).
// TQ, the study's queries a block, does not tile this grid: it is checked
// and otherwise unused.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

// value [B,H,S,D]; loc [B,H,Q,L,P,2] f32; attn [B,H,Q,L,P] f32;
// out [B,H,Q,D]; the grid and warp of `walk_points` on the head-major
// layout.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARP_GRID_THREADS)
    fwd_v2_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  walk_points<T, VEC, HEAD_MAJOR>(value, loc, attn, out, S, Q, H, D, L, P, G,
                                  n_warps, lv, HatPoint());
}

template <typename T, bool VEC>
struct FwdV2 {
  static WarpGridKernel<T> fn() { return fwd_v2_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). All operands
// head-major, as above. D <= 128 and L*P <= 64.
extern "C" int ms_deform_attn_fwd_v2(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  return warp_grid_entry<FwdV2>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                L, P, TQ, hw, stream);
}
