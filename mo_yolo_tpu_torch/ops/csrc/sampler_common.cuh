// What the sampler kernels (K1 ms_deform_attn_fwd.cu, K2
// ms_deform_attn_bwd.cu and the study's ms_deform_attn_fwd_*.cu) share: the
// level table, the conversions between the value dtype and f32 and the
// rounding of an f32 intermediate to the value dtype, the coordinate
// rounding, the staging of a query tile's loc and attn into shared memory,
// one point's hat-weighted sample (v1 and v2), 16-byte row pieces (v3, v7,
// K1, K2), two-element row pieces with the value dtype's packed product
// (v45, nocy and v6), and the sub-group row plan and a warp's points handed
// out by shuffles (K1, K2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 8
// what one block may take of an SM's shared memory on sm_90 (227 KB)
#define MAX_DYNAMIC_SMEM 232448

struct Levels {
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  long long start[MAX_LEVELS];  // first row of level l in S
};

// Fills the table from L pairs (h, w); false when they do not sum to S.
static inline bool fill_levels(Levels& lv, const int* hw, int L, int S) {
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.start[l] = start;
    start += (long long)lv.h[l] * lv.w[l];
  }
  return start == S;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// An f32 intermediate rounded to the value dtype and back: where the TPU
// kernel casts to the value dtype, the port's kernels round here.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Pixel coordinate loc*n - 0.5 with the plain version's two roundings: a
// fused multiply-add could move a point across a pixel edge.
__device__ __forceinline__ float pixel(float loc, int n) {
  return __fsub_rn(__fmul_rn(loc, (float)n), 0.5f);
}

// Hat weight of the tap at integer position c for the coordinate x.
__device__ __forceinline__ float hat(float x, float c) {
  return fmaxf(1.f - fabsf(x - c), 0.f);
}

// Float bounds test: NaN or inf coordinates fall outside, as in JAX.
__device__ __forceinline__ bool inside(float c, int n) {
  return c >= 0.f && c <= (float)(n - 1);
}

// Copies `n` consecutive floats from global to shared memory with
// coalesced loads, all threads of the block taking part.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One point's bilinear sample of element d of a level's map, with hat
// weights: sum_y hat(y, cy) * (sum_x hat(x, cx) * v[cy, cx, d]) over the
// taps c = floor and floor + 1. A tap outside the map is skipped, as it
// matches no column on the TPU. `vl` points at the level's first row for
// this head and `row` is the distance in elements between neighbouring
// pixels.
template <typename T>
__device__ __forceinline__ float hat_sample(const T* __restrict__ vl,
                                            long long row, int d, float x,
                                            float y, int hl, int wl) {
  const float x0 = floorf(x), y0 = floorf(y);
  float s = 0.f;
#pragma unroll
  for (int cy = 0; cy < 2; ++cy) {
    const float fy = y0 + (float)cy;
    if (!inside(fy, hl)) continue;
    float t = 0.f;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float fx = x0 + (float)cx;
      if (!inside(fx, wl)) continue;
      const long long s_idx = (long long)fy * wl + (long long)fx;
      t += hat(x, fx) * to_f32(vl[s_idx * row + d]);
    }
    s += hat(y, fy) * t;
  }
  return s;
}

// 16 bytes of the value type as N floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __half* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__half* p, const float* v) {
    uint4 r;
    __half2* h = reinterpret_cast<__half2*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// Two neighbouring elements of a row as a float2, and the value dtype's
// packed pair: `round` rounds a float2 to it; `mul(a, w)` rounds a and w to
// it and multiplies them there (one `__hmul2` in bf16 and fp16, which is
// correctly rounded, as the TPU kernel's product in the value dtype),
// returned as floats.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float2 round(float2 v) { return v; }
  static __device__ __forceinline__ float2 mul(float2 a, float w) {
    return make_float2(a.x * w, a.y * w);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float2 round(float2 v) {
    return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  }
  static __device__ __forceinline__ float2 mul(float2 a, float w) {
    return __bfloat1622float2(__hmul2(__floats2bfloat162_rn(a.x, a.y),
                                      __float2bfloat162_rn(w)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <>
struct Pair<__half> {
  static __device__ __forceinline__ float2 load(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ float2 round(float2 v) {
    return __half22float2(__floats2half2_rn(v.x, v.y));
  }
  static __device__ __forceinline__ float2 mul(float2 a, float w) {
    return __half22float2(__hmul2(__floats2half2_rn(a.x, a.y),
                                  __float2half2_rn(w)));
  }
  static __device__ __forceinline__ void store(__half* p, float2 v) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v.x, v.y);
  }
};

// v1's skeleton with two elements a lane, shared by the v45, nocy and v6
// kernels. Block (tile, b) owns queries [tile*TQ, tile*TQ + TQ) of batch b
// with all heads; the tile's loc and attn ([nq, H, L, P, 2] and
// [nq, H, L, P] f32) are staged into shared memory with coalesced loads.
// G lanes (a power of two, 2G >= D) carry the row of one (q, h) pair, two
// elements a lane, so a warp carries 32/G pairs at once (two at D=32).
// For each pair, every lane of the warp calls
//   body(lp, ap, vb, row, live) -> float2,
// lp and ap the pair's loc and attn, vb the pair's head and first element
// in batch b's value, row the distance in elements between pixels, and
// `live` false for a lane with no element (D < 2G) or no pair (the warp's
// last round); such a lane must not load, but reaches every shuffle. The
// live lanes store the result as elements d0, d0 + 1 of the pair's row.
template <typename T, typename Body>
__device__ __forceinline__ void walk_pairs(const T* __restrict__ value,
                                           const float* __restrict__ loc,
                                           const float* __restrict__ attn,
                                           T* __restrict__ out, int S, int Q,
                                           int H, int D, int L, int P, int TQ,
                                           int G, Body body) {
  extern __shared__ float smem[];
  const int LP = L * P;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, Q - q0);  // the last tile may be partial
  const int n_pairs = nq * H;
  float* s_loc = smem;                           // [nq, H, L, P, 2]
  float* s_attn = smem + (size_t)TQ * H * LP * 2;  // [nq, H, L, P]
  const long long first = ((long long)b * Q + q0) * H;  // first (q, h) row
  stage(s_loc, loc + first * LP * 2, n_pairs * LP * 2);
  stage(s_attn, attn + first * LP, n_pairs * LP);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int per_warp = 32 / G, slot = lane / G;
  const int d0 = (lane & (G - 1)) * 2;
  const long long row = (long long)H * D;
  // the trip count depends on the warp alone, so every lane reaches the
  // body's shuffles
  for (int base = warp * per_warp; base < n_pairs;
       base += n_warps * per_warp) {
    const bool live = base + slot < n_pairs && d0 < D;
    const int pair = min(base + slot, n_pairs - 1);  // pair = q_local*H + h
    const int h = pair % H;
    const T* vb = value + (long long)b * S * row + (long long)h * D +
                  min(d0, D - 2);
    const float2 r = body(s_loc + pair * LP * 2, s_attn + pair * LP, vb, row,
                          live);
    if (live) Pair<T>::store(out + (first + pair) * D + d0, r);
  }
}

// G for `walk_pairs`: the least power of two with 2G >= D; 0 where the
// skeleton does not take D (odd, or more than 64 elements).
static inline int pair_lanes(int D) {
  if (D < 2 || D % 2 != 0 || D > 64) return 0;
  int G = 1;
  while (2 * G < D) G *= 2;
  return G;
}

// ---------------------------------------------------------------- K1, K2

// A lane's piece of a row: N consecutive elements as floats. With VEC it is
// 16 bytes (`Vec<T>`), so the row must be a multiple of 16 bytes on a
// 16-byte boundary; without, one element (any D, any alignment).
template <typename T, bool VEC>
struct Piece;

template <typename T>
struct Piece<T, true> {
  static constexpr int N = Vec<T>::N;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    Vec<T>::load(p, v);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    Vec<T>::store(p, v);
  }
};

template <typename T>
struct Piece<T, false> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void load(const T* p, float* v) {
    v[0] = to_f32(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float* v) {
    *p = from_f32<T>(v[0]);
  }
};

// The most elements a row may have: four pieces of one element a lane.
#define MAX_ROW_D 128

// Lanes G (a power of two, at most 32) that carry one row of D elements in
// pieces of N, K pieces a lane: the least G with G * K * N >= D. 0 where
// the row does not fit.
static inline int row_lanes(int D, int N, int K) {
  const int pieces = (D + N - 1) / N;
  int G = 1;
  while (G < 32 && G * K < pieces) G *= 2;
  return G * K >= pieces ? G : 0;
}

// Pieces a lane carries in K1 and K2: one 16-byte piece, or four elements
// without 16-byte pieces. (Two 16-byte pieces a lane, so that a warp takes
// all its points in one trip, ran K1 slower on the card: 112 registers a
// thread left fewer warps in flight.)
__host__ __device__ constexpr int row_pieces(bool vec) { return vec ? 1 : 4; }

// The C entry points' shape block: dtype, B, S, Q, H, D, L, P, then L
// pairs (h, w). One int array, made once for each shape by the wrapper, so
// that a launch converts few arguments.
struct Dims {
  int dtype, B, S, Q, H, D, L, P;
  Levels lv;
};

// Reads and checks a shape block; false when the levels do not sum to S.
static inline bool read_dims(const int* d, Dims& out) {
  out.dtype = d[0];
  out.B = d[1];
  out.S = d[2];
  out.Q = d[3];
  out.H = d[4];
  out.D = d[5];
  out.L = d[6];
  out.P = d[7];
  if (out.L < 1 || out.L > MAX_LEVELS) return false;
  return fill_levels(out.lv, d + 8, out.L, out.S);
}

// Level l's height, width and first row, read with constant indices so
// that the table stays in the kernel's parameter space (an index known
// only at run time would copy it to local memory).
__device__ __forceinline__ void level_at(const Levels& lv, int l, int& hl,
                                         int& wl, long long& first) {
  hl = lv.h[0];
  wl = lv.w[0];
  first = lv.start[0];
#pragma unroll
  for (int j = 1; j < MAX_LEVELS; ++j) {
    if (l == j) {
      hl = lv.h[j];
      wl = lv.w[j];
      first = lv.start[j];
    }
  }
}

// Whether the rows of a [.., D] tensor at p take 16-byte pieces.
template <typename T>
static inline bool rows_vec16(const void* p, int D) {
  return (D * (int)sizeof(T)) % 16 == 0 && ((uintptr_t)p & 15) == 0;
}

// Element offset of piece k of a lane at sub-lane sl, with G lanes a row.
template <int N>
__device__ __forceinline__ int piece_at(int sl, int k, int G) {
  return (sl + k * G) * N;
}

// The largest L*P a warp's points may have: loc has 2*L*P floats, held
// 32 to a register across the warp's lanes.
#define MAX_LP 64

// One (b, q, h)'s loc ([L*P, 2]) and attn ([L*P]) held across a warp's
// lanes: lane l keeps elements l, l + 32, ... of each, loaded once with
// coalesced loads. `get` hands point i's values to the lane that asks;
// every lane of the warp must call it (it shuffles).
struct WarpPoints {
  float loc[(2 * MAX_LP) / 32];
  float attn[MAX_LP / 32];
  int n_loc, n_attn;  // registers in use

  __device__ __forceinline__ void load(const float* __restrict__ locp,
                                       const float* __restrict__ attnp,
                                       int LP, int lane) {
    n_loc = (2 * LP + 31) / 32;
    n_attn = (LP + 31) / 32;
#pragma unroll
    for (int k = 0; k < (2 * MAX_LP) / 32; ++k) {
      const int e = lane + 32 * k;
      loc[k] = (k < n_loc && e < 2 * LP) ? locp[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < MAX_LP / 32; ++k) {
      const int e = lane + 32 * k;
      attn[k] = (k < n_attn && e < LP) ? attnp[e] : 0.f;
    }
  }

  template <int R>
  static __device__ __forceinline__ float pick(const float (&r)[R], int n,
                                               int e) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (k < n) {  // n is the same in every lane
        const float t = __shfl_sync(0xffffffffu, r[k], e & 31);
        if ((e >> 5) == k) v = t;
      }
    }
    return v;
  }

  __device__ __forceinline__ void get(int i, float& lx, float& ly,
                                      float& a) const {
    lx = pick(loc, n_loc, 2 * i);
    ly = pick(loc, n_loc, 2 * i + 1);
    a = pick(attn, n_attn, i);
  }
};

// One point's four corners at its level: pixel coordinate, bounds test and
// bilinear weights, as the plain version computes them. Corner c is
// (c & 1, c >> 1): x0 + (c & 1), y0 + (c >> 1).
struct Corners {
  float tx, ty;
  bool ok[4];
  long long s[4];  // row of the corner within its level (0 outside)

  __device__ __forceinline__ void at(float lx, float ly, int hl, int wl,
                                     bool live) {
    const float x = pixel(lx, wl), y = pixel(ly, hl);
    const float x0 = floorf(x), y0 = floorf(y);
    tx = x - x0;
    ty = y - y0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float fx = x0 + (float)(c & 1), fy = y0 + (float)(c >> 1);
      // the float bounds test before the index: NaN or inf fall outside
      ok[c] = live && inside(fx, wl) && inside(fy, hl);
      s[c] = ok[c] ? (long long)fy * wl + (long long)fx : 0;
    }
  }
  __device__ __forceinline__ float wx(int c) const {
    return (c & 1) ? tx : 1.f - tx;
  }
  __device__ __forceinline__ float wy(int c) const {
    return (c >> 1) ? ty : 1.f - ty;
  }
};
