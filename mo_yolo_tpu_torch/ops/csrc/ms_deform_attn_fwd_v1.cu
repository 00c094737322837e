// Forward sampler, study variant v1, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v1`
// (launched by `fwd_v1`). It computes the sampler's function,
//
//   out[b,q,h,:] = sum_l sum_p attn[b,q,h,l,p] *
//                  bilinear(V_l[b,:,:,h,:], loc_x*W_l - 0.5, loc_y*H_l - 0.5)
//
// with what v1 studies: bilinear weights as hat functions relu(1 - |x - c|),
// and the attention weight applied to each point's sample
//
//   s = sum_y hat(y, r) * sum_x hat(x, c) * v[r, c]
//
// after its corners are summed, not folded into the x weight. Sums are f32
// and the output is rounded once. The TPU kernel is a chain of one-hot
// matrix products over a block of (batch, query tile) with all heads,
// because Mosaic cannot gather and its grid runs in order on one core; here
// each corner is a direct load.
//
// What bounds it on the card: bytes (about 3 flops per value read), and
// before them the loads a warp keeps in flight. The TPU's grid gave 10
// blocks at Q=600 on 132 SMs, each warp walking its (q, h) pairs in turn
// with one element a lane. So the design is the main-path kernel's
// (`ms_deform_attn_fwd.cu`) with v1's arithmetic, shared with v2, v3, v45
// and v6 (`walk_points` in sampler_common.cuh):
//
// - the grid: one warp per (b, q, h), on the native [B,S,H,D] value (4,800
//   warps at Q=600);
// - the warp: the flat loop over the L*P points, one point at a time in
//   each of 32/G sub-groups of G lanes, which load its four corner rows in
//   16-byte pieces (`Piece<T, true>`); each lane sums its piece's s times
//   attn in f32 (`HatPoint`, the body v2 shares), a shuffle reduction joins
//   the sub-groups, and sub-group 0 stores the row with 16-byte stores;
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
    fwd_v1_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  walk_points<T, VEC>(value, loc, attn, out, S, Q, H, D, L, P, G, n_warps,
                      lv, HatPoint());
}

template <typename T, bool VEC>
struct FwdV1 {
  static WarpGridKernel<T> fn() { return fwd_v1_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v1(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  return warp_grid_entry<FwdV1>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                L, P, TQ, hw, stream);
}
