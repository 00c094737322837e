// Multi-scale deformable-attention forward sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel `mo_yolo_tpu/ops/deform_attn_pallas.py:_kernel`
// (launched by `_forward`). That kernel builds one-hot interpolation
// matrices and multiplies them on the MXU, because Mosaic cannot gather.
// On Hopper the sampler is a direct gather:
//
//   out[b,q,h,:] = sum_l sum_p attn[b,q,h,l,p] *
//                  bilinear(V_l[b,:,:,h,:], loc_x*W_l - 0.5, loc_y*H_l - 0.5)
//
// with zero contribution from corners outside the map.
//
// What bounds it on the card: bytes. Per (b,q,h) it reads L*P*4 corner
// rows of D values and does ~3 flops per value, far below the H100's
// ridge (~295 flops/byte in bf16). The least traffic reads the value
// rows the corners touch once (~10 MB in bf16 at 1536x800, S=25,200) plus
// loc/attn/out; rows of neighbouring queries overlap, so most corner reads
// hit L2 (50 MB holds the whole value tensor). What the sampler study
// found on this card (blocks in flight first, then taps in flight per
// warp) sets the design:
//
// - the grid: one warp per (b,q,h), on the native [B,S,H,D] value, no
//   transposes (4,800 warps at Q=600);
// - the warp: the flat loop over the L*P*4 taps, four at a time (the
//   corners of one point) in each of 32/G sub-groups of G lanes; a
//   sub-group carries a row with 16-byte loads (four lanes for a bf16 row
//   at D=32: 8 sub-groups, 32 rows in flight where one warp-wide row was);
//   the attention weight is folded into the x weight, sums are f32
//   partial rows, a shuffle reduction meets the sub-groups and sub-group 0
//   writes the row with 16-byte stores;
// - loc and attn are loaded once per warp with coalesced lane loads and
//   handed out by shuffles (`WarpPoints`); the level table is read with
//   constant indices (`level_at`), so it stays out of local memory.
//
// A row that is not a multiple of 16 bytes, or not on a 16-byte boundary,
// takes the same kernel with one element a lane piece (`Piece<T, false>`),
// chosen here by the shape and the pointers.
//
// Plain C entry point, bound with ctypes; the shapes come as one int block
// (`Dims`), so that a launch converts six arguments. It launches on the
// caller's stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 256  // 8 warps a block

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. One warp per (b,q,h): warp index = (b*Q + q)*H + h,
// which is also the row of loc/attn/out it owns. G lanes carry a row, K
// pieces a lane.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(THREADS)
    ms_deform_attn_fwd_kernel(const T* __restrict__ value,
                              const float* __restrict__ loc,
                              const float* __restrict__ attn,
                              T* __restrict__ out, int S, int Q, int H, int D,
                              int L, int P, int G, long long n_warps,
                              Levels lv) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  const int h = (int)(warp % H);
  const long long b = warp / H / Q;
  const int LP = L * P;
  WarpPoints pts;
  pts.load(loc + warp * LP * 2, attn + warp * LP, LP, lane);
  const int group = lane / G, n_groups = 32 / G, sl = lane & (G - 1);
  const long long row = (long long)H * D;  // elements between rows of S
  const T* vb = value + b * S * row + (long long)h * D;

  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[k][n] = 0.f;
  // the trip count depends on the warp alone, so every lane reaches the
  // shuffles
  for (int i0 = 0; i0 < LP; i0 += n_groups) {
    const int i = i0 + group;  // i = l * P + p
    const bool live = i < LP;
    float lx, ly, a;
    pts.get(live ? i : 0, lx, ly, a);
    int hl, wl;
    long long first;
    level_at(lv, (live ? i : 0) / P, hl, wl, first);
    Corners cn;
    cn.at(lx, ly, hl, wl, live);
    const T* vl = vb + first * row;
    float v[4][K][N];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = piece_at<N>(sl, k, G);
        if (cn.ok[c] && e < D) {
          R::load(vl + cn.s[c] * row + e, v[c][k]);
        } else {
#pragma unroll
          for (int n = 0; n < N; ++n) v[c][k][n] = 0.f;
        }
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // attn folded into the x weight, as the study's v3; 0 outside
      const float w = cn.ok[c] ? (cn.wx(c) * a) * cn.wy(c) : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[k][n] += w * v[c][k][n];
    }
  }
  for (int off = 16; off >= G; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int n = 0; n < N; ++n)
        acc[k][n] += __shfl_xor_sync(0xffffffffu, acc[k][n], off);
  if (group == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = piece_at<N>(sl, k, G);
      if (e < D) R::store(out + warp * D + e, acc[k]);
    }
  }
}

template <typename T, bool VEC, int K>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int B, int S, int Q, int H, int D, int L, int P,
                  const Levels& lv, cudaStream_t stream) {
  const int G = row_lanes(D, Piece<T, VEC>::N, K);
  if (G == 0) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * H;
  const long long blocks = (n_warps * 32 + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  ms_deform_attn_fwd_kernel<T, VEC, K>
      <<<(unsigned)blocks, THREADS, 0, stream>>>(
          (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S,
          Q, H, D, L, P, G, n_warps, lv);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rows(const void* value, const void* loc, const void* attn,
                       void* out, const Dims& d, cudaStream_t stream) {
  if (rows_vec16<T>(value, d.D) && rows_vec16<T>(out, d.D))
    return launch<T, true, row_pieces(true)>(value, loc, attn, out, d.B, d.S,
                                             d.Q, d.H, d.D, d.L, d.P, d.lv,
                                             stream);
  return launch<T, false, row_pieces(false)>(value, loc, attn, out, d.B, d.S,
                                             d.Q, d.H, d.D, d.L, d.P, d.lv,
                                             stream);
}

// dims: dtype (0 = f32, 1 = bf16, 2 = fp16: value and out), B, S, Q, H, D,
// L, P, then L pairs (h, w). D <= 128 and L*P <= 64.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc,
                                  const void* attn, void* out,
                                  const int* dims, void* stream) {
  Dims d;
  if (!read_dims(dims, d) || d.D < 1 || d.D > MAX_ROW_D || d.B < 1 ||
      d.Q < 1 || d.H < 1 || d.P < 1 || d.L * d.P > MAX_LP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d.dtype) {
    case 0:
      return launch_rows<float>(value, loc, attn, out, d, st);
    case 1:
      return launch_rows<__nv_bfloat16>(value, loc, attn, out, d, st);
    case 2:
      return launch_rows<__half>(value, loc, attn, out, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
