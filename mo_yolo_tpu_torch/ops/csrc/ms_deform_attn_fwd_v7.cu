// Forward sampler, study variant v7, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v7`
// (launched by `fwd_v7`). The TPU kernel is v3's arithmetic (the levels
// fused into one block-diagonal pass, per-level guards) on v2's grid
// (batch, head, query tile) over a head-contiguous value, with the same
// rounding points as v3:
//
//   wx = (1 - tx)*a and tx*a, guarded, rounded to the value dtype
//   wy = 1 - ty and ty, guarded, f32
//   u  = (wx0*v[y, x0] + wx1*v[y, x0+1]) * wy in f32, rounded to the value
//        dtype
//   s  = sum over the levels and y taps of one point's u, in f32, rounded
//        to the value dtype
//   out = sum over the points of s in f32, rounded once.
//
// What bounds it on the card: bytes (the corner rows, as the main-path
// kernel), and before them the loads a warp keeps in flight. The TPU's grid
// (a 512-thread block per (query tile, head, batch): 80 blocks at Q=600,
// TQ=64, on 132 SMs, the tile's loc and attn staged in shared memory, a
// warp's queries one after another) was what the card paid for, and so
// were the wrapper's copies of loc, attn and the output to and from
// head-major. So the design is the main-path kernel's grid and warp
// (sampler_common.cuh) with v7's arithmetic:
//
// - the grid: one warp per (b, h, q), in that order over the head-major
//   [B,H,S,D] value, so that consecutive warps share a head's slab (4,800
//   warps at Q=600), launched through `warp_grid_entry`; loc and attn are
//   read in their native [B,Q,H,...] rows and out is written straight
//   into [B,Q,H*D]: the warp for (b, h, q) owns row (b*Q + q)*H + h of
//   each. Only the value is copied head-major, which is what v7 studies;
// - the warp: loc and attn by shuffles (`WarpPoints`); sub-groups of G
//   lanes carry a row in pieces (`Piece<T, VEC>`), and the rounding point
//   s is per point, so the sub-groups split the points: gpp sub-groups
//   share a point (the largest power of two with gpp*P <= 32/G, two at
//   D=32 bf16), each takes every gpp-th of its 2*L (level, y tap) units,
//   two of them a trip (four corner-row loads in flight); an xor-shuffle
//   join of the point's sub-groups gives s, one of them adds s rounded,
//   and a last shuffle sums the points; one 16-byte store a piece.
//
// A tap outside its level is loaded as zeros and its weight zeroed by a
// select, as the guards do. A row that is not a multiple of 16 bytes, or
// not on a 16-byte boundary, takes the same kernel with one element a lane
// piece (`Piece<T, false>`). TQ, the study's queries a block, does not
// tile this grid: it is checked and otherwise unused.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

// One (level, y tap) unit of a point: its two x taps' rows in the level
// (x0 and x0 + 1 on row y0 + cy), their weights wx (rounded to the value
// dtype, 0 outside) and the y weight wy (f32, 0 outside).
struct Unit {
  float w[2], wy;
  bool ok[2];
  int s[2];

  template <typename T>
  __device__ __forceinline__ void at(float lx, float ly, float a, int hl,
                                     int wl, int cy, bool live) {
    const float x = pixel(lx, wl), y = pixel(ly, hl);
    const float x0 = floorf(x), y0 = floorf(y);
    const float tx = x - x0, ty = y - y0;
    const float fy = y0 + (float)cy;
    const bool y_in = live && inside(fy, hl);
    wy = y_in ? (cy ? ty : 1.f - ty) : 0.f;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float fx = x0 + (float)cx;
      ok[cx] = y_in && inside(fx, wl);
      w[cx] = ok[cx] ? round_to<T>((cx ? tx : 1.f - tx) * a) : 0.f;
      s[cx] = ok[cx] ? (int)fy * wl + (int)fx : 0;
    }
  }
};

// A lane's piece of a corner row as loaded, kept in the value dtype until
// its product: a 16-byte bf16 piece takes four registers, not eight (with
// eight, the bf16 kernels needed 114 registers a thread).
template <typename T, bool VEC>
struct Packed;

template <typename T>
struct Packed<T, true> {
  uint4 bits;
  __device__ __forceinline__ void load(const T* p) {
    bits = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { bits = make_uint4(0u, 0u, 0u, 0u); }
  // 32-bit word i of the piece (i a constant once unrolled)
  __device__ __forceinline__ unsigned word(int i) const {
    return i == 0 ? bits.x : i == 1 ? bits.y : i == 2 ? bits.z : bits.w;
  }
  // element n as f32
  __device__ __forceinline__ float at(int n) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(n));
    } else {
      const unsigned w = word(n >> 1);
      const unsigned short h = (unsigned short)((n & 1) ? w >> 16 : w);
      return to_f32(*reinterpret_cast<const T*>(&h));
    }
  }
};

template <typename T>
struct Packed<T, false> {
  T bits;
  __device__ __forceinline__ void load(const T* p) { bits = *p; }
  __device__ __forceinline__ void zero() { bits = from_f32<T>(0.f); }
  __device__ __forceinline__ float at(int) const { return to_f32(bits); }
};

// value [B,H,S,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. Warp (b*H + h)*Q + q; G lanes carry a row, K pieces of N
// elements a lane.
template <typename T, bool VEC>
__global__ void __launch_bounds__(WARP_GRID_THREADS)
    fwd_v7_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N, K = row_pieces(VEC);
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  const long long slab = warp / Q;  // b*H + h: the head's [S,D] of value
  const long long b = slab / H;
  const long long row = (b * Q + (warp - slab * Q)) * H + (slab - b * H);
  const int LP = L * P;
  WarpPoints pts;
  pts.load(loc + row * LP * 2, attn + row * LP, LP, lane);
  const int group = lane / G, n_groups = 32 / G, sl = lane & (G - 1);
  int gpp = 1;  // sub-groups a point
  while (2 * gpp * P <= n_groups) gpp *= 2;
  const int k = group % gpp;             // this sub-group's share of a point
  const int per_round = n_groups / gpp;  // points a round
  const int n_units = 2 * L;             // (level, y tap) units of a point
  const T* vb = value + slab * S * D;

  float acc[K][N];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[kk][n] = 0.f;
  // the trip counts below that hold a shuffle depend on the warp alone, so
  // every lane reaches the shuffles
  for (int p0 = 0; p0 < P; p0 += per_round) {
    const int p = p0 + group / gpp;
    float s[K][N];
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int n = 0; n < N; ++n) s[kk][n] = 0.f;
    // units k, k + gpp, ... of point p, two a trip
    for (int j0 = 0; j0 < n_units; j0 += 2 * gpp) {
      Unit un[2];
      const T* vl[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = j0 + t * gpp + k;
        const bool live = p < P && j < n_units;
        const int l = live ? j >> 1 : 0;
        float lx, ly, a;
        pts.get(l * P + (live ? p : 0), lx, ly, a);
        int hl, wl;
        long long first;
        level_at(lv, l, hl, wl, first);
        un[t].at<T>(lx, ly, a, hl, wl, j & 1, live);
        vl[t] = vb + first * D;
      }
      Packed<T, VEC> v[2][2][K];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int cx = 0; cx < 2; ++cx)
#pragma unroll
          for (int kk = 0; kk < K; ++kk) {
            const int e = piece_at<N>(sl, kk, G);
            if (un[t].ok[cx] && e < D) {
              v[t][cx][kk].load(vl[t] + (long long)un[t].s[cx] * D + e);
            } else {
              v[t][cx][kk].zero();
            }
          }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
#pragma unroll
          for (int n = 0; n < N; ++n) {
            // the x taps in the TPU kernel's order, then the y weight
            const float u =
                __fmaf_rn(un[t].w[1], v[t][1][kk].at(n),
                          __fmul_rn(un[t].w[0], v[t][0][kk].at(n)));
            s[kk][n] += round_to<T>(__fmul_rn(u, un[t].wy));
          }
    }
    // the point's sub-groups meet; s is rounded before the point sum
    for (int off = G; off < G * gpp; off <<= 1)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int n = 0; n < N; ++n)
          s[kk][n] += __shfl_xor_sync(0xffffffffu, s[kk][n], off);
    if (k == 0 && p < P)
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[kk][n] += round_to<T>(s[kk][n]);
  }
  // the point sum across the sub-groups that hold a point's s
  for (int off = G * gpp; off < 32; off <<= 1)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int n = 0; n < N; ++n)
        acc[kk][n] += __shfl_xor_sync(0xffffffffu, acc[kk][n], off);
  if (group == 0) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int e = piece_at<N>(sl, kk, G);
      if (e < D) R::store(out + row * D + e, acc[kk]);
    }
  }
}

template <typename T, bool VEC>
struct FwdV7 {
  static WarpGridKernel<T> fn() { return fwd_v7_kernel<T, VEC>; }
};

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). value head-major
// [B,H,S,D]; loc, attn and out in their native layouts. D <= 128 and
// L*P <= 64.
extern "C" int ms_deform_attn_fwd_v7(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  return warp_grid_entry<FwdV7>(value, loc, attn, out, dtype, B, S, Q, H, D,
                                L, P, TQ, hw, stream);
}
