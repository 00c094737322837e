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
// (`ms_deform_attn_fwd.cu`) with v1's arithmetic:
//
// - the grid: one warp per (b, q, h), on the native [B,S,H,D] value (4,800
//   warps at Q=600);
// - the warp: the flat loop over the L*P points, one point at a time in
//   each of 32/G sub-groups of G lanes, which load its four corner rows in
//   16-byte pieces (`Piece<T, true>`); each lane sums its piece's s times
//   attn in f32, a shuffle reduction joins the sub-groups, and sub-group 0
//   stores the row with 16-byte stores;
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

#define THREADS 256  // 8 warps a block

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. One warp per (b,q,h): warp index = (b*Q + q)*H + h, also
// the row of loc/attn/out it owns. G lanes carry a row, K pieces a lane.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(THREADS)
    fwd_v1_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
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
    float v[4][K][N];
    load_corners<T, VEC, K>(cn, vb + first * row, row, sl, G, D, v);
    // hat weights of the taps x0, x0 + 1 and rows y0, y0 + 1; a corner
    // outside its level was loaded as zeros, and a hat weight is finite
    const float x = pixel(lx, wl), y = pixel(ly, hl);
    const float x0 = floorf(x), y0 = floorf(y);
    const float hx[2] = {hat(x, x0), hat(x, x0 + 1.f)};
    const float hy[2] = {hat(y, y0), hat(y, y0 + 1.f)};
    const float aw = live ? a : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float s = 0.f;
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const float t = hx[0] * v[2 * cy][k][n] + hx[1] * v[2 * cy + 1][k][n];
          s += hy[cy] * t;
        }
        acc[k][n] += aw * s;  // attn on the point's sample
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
  fwd_v1_kernel<T, VEC, K><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, G, n_warps, lv);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rows(const void* value, const void* loc, const void* attn,
                       void* out, int B, int S, int Q, int H, int D, int L,
                       int P, const Levels& lv, cudaStream_t stream) {
  if (rows_vec16<T>(value, D) && rows_vec16<T>(out, D))
    return launch<T, true, row_pieces(true)>(value, loc, attn, out, B, S, Q,
                                             H, D, L, P, lv, stream);
  return launch<T, false, row_pieces(false)>(value, loc, attn, out, B, S, Q,
                                             H, D, L, P, lv, stream);
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v1(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || D > MAX_ROW_D || B < 1 || Q < 1 ||
      H < 1 || P < 1 || L * P > MAX_LP || TQ < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, hw, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_rows<float>(value, loc, attn, out, B, S, Q, H, D, L, P,
                                lv, st);
    case 1:
      return launch_rows<__nv_bfloat16>(value, loc, attn, out, B, S, Q, H, D,
                                        L, P, lv, st);
    case 2:
      return launch_rows<__half>(value, loc, attn, out, B, S, Q, H, D, L, P,
                                 lv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
