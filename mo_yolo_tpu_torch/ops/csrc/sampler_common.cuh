// What the sampler kernels (K1 ms_deform_attn_fwd.cu, K2
// ms_deform_attn_bwd.cu and the study's ms_deform_attn_fwd_*.cu) share: the
// level table, the conversions between the value dtype and f32 and the
// rounding of an f32 intermediate to the value dtype, the coordinate
// rounding, the staging of a query tile's loc and attn into shared memory
// (v7), 16-byte row pieces (v7, K1, K2, nocy, v1-v3, v45, v6, v8), the
// sub-group row plan, a warp's points handed out by shuffles and a point's
// corner rows (K1, K2, nocy, v1-v3, v45, v6, v8), K1's warp grid on the
// native or the head-major layout with its launch and C entry point for
// the study variants that sum a row over the points (v1-v3, v45, v6), and
// the hat-weight body that v1 and v2 share.

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

// A point's four corner rows as a sub-group carries them: piece k of
// sub-lane sl of each corner c (`Corners`), zeros where the corner is
// outside its level or the piece past D. `vl` is the level's first row for
// this head, `row` the elements between rows of S.
template <typename T, bool VEC, int K>
__device__ __forceinline__ void load_corners(
    const Corners& cn, const T* __restrict__ vl, long long row, int sl,
    int G, int D, float (&v)[4][K][Piece<T, VEC>::N]) {
  constexpr int N = Piece<T, VEC>::N;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = piece_at<N>(sl, k, G);
      if (cn.ok[c] && e < D) {
        Piece<T, VEC>::load(vl + cn.s[c] * row + e, v[c][k]);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) v[c][k][n] = 0.f;
      }
    }
}

// ---------------------------------- K1's warp grid (v1, v2, v3, v45, v6)

#define WARP_GRID_THREADS 256  // 8 warps a block

// Where a warp of the grid finds its rows. In both layouts the warp index
// is also the row of loc, attn and out that the warp owns.
// NATIVE: warp = (b*Q + q)*H + h; value [B,S,H,D] (row stride H*D, head
// offset h*D), loc [B,Q,H,L,P,2], attn [B,Q,H,L,P], out [B,Q,H*D].
// HEAD_MAJOR: warp = (b*H + h)*Q + q; value [B,H,S,D] (row stride D, base
// (b*H + h)*S*D), loc [B,H,Q,L,P,2], attn [B,H,Q,L,P], out [B,H,Q,D].
enum GridLayout { NATIVE, HEAD_MAJOR };

// K1's grid and warp for a study variant that sums each lane's piece of
// the row over the points: one warp per (b, q, h) on `LAYOUT`, loc and attn
// f32. The flat loop over the L*P points takes one point at a time in each
// of 32/G sub-groups of G lanes, K pieces of N elements a lane. For each
// point, every lane calls
//   body(cn, x, y, a, v, acc)
// cn the point's corners at its level (`Corners`; none inside for a lane
// past the last point), x and y its pixel coordinates, a its attn weight
// (0 past the last point), v the lane's pieces of the four corner rows
// (zeros outside, `load_corners`) and acc the lane's f32 sums, to which
// the body adds the point's terms. A shuffle reduction then joins the
// sub-groups, and sub-group 0 stores the row, rounded once.
template <typename T, bool VEC, GridLayout LAYOUT = NATIVE, typename Body>
__device__ __forceinline__ void walk_points(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, T* __restrict__ out, int S, int Q, int H,
    int D, int L, int P, int G, long long n_warps, const Levels& lv,
    Body body) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N, K = row_pieces(VEC);
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  // NATIVE's head and batch (unused in HEAD_MAJOR), before the points'
  // loads: computed after them, in a NATIVE-only branch, they change v1's
  // register allocation (`ptxas -v`)
  const int h = (int)(warp % H);
  const long long b = warp / H / Q;
  const int LP = L * P;
  WarpPoints pts;
  pts.load(loc + warp * LP * 2, attn + warp * LP, LP, lane);
  const int group = lane / G, n_groups = 32 / G, sl = lane & (G - 1);
  // elements between rows of S, and the warp's head's first row of S
  const long long row = LAYOUT == HEAD_MAJOR ? (long long)D
                                             : (long long)H * D;
  const T* vb = LAYOUT == HEAD_MAJOR ? value + warp / Q * S * row
                                     : value + b * S * row + (long long)h * D;

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
    body(cn, pixel(lx, wl), pixel(ly, hl), live ? a : 0.f, v, acc);
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

// v1's arithmetic for one point, a body of `walk_points` that v1 (native
// layout) and v2 (head-major) share: hat weights relu(1 - |x - c|) of the
// taps x0, x0 + 1 and the rows y0, y0 + 1, the point's sample summed in
// f32, and the attention weight on that sum:
//   acc += a * sum_y hat(y, r) * sum_x hat(x, c) * v[r, c]
// A corner outside its level was loaded as zeros, and a hat weight is
// finite (0 for a coordinate that is not), so nothing is tested here.
struct HatPoint {
  template <int K, int N>
  __device__ __forceinline__ void operator()(const Corners&, float x,
                                             float y, float a,
                                             const float (&v)[4][K][N],
                                             float (&acc)[K][N]) const {
    const float x0 = floorf(x), y0 = floorf(y);
    const float hx[2] = {hat(x, x0), hat(x, x0 + 1.f)};
    const float hy[2] = {hat(y, y0), hat(y, y0 + 1.f)};
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float s = 0.f;
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const float t =
              hx[0] * v[2 * cy][k][n] + hx[1] * v[2 * cy + 1][k][n];
          s += hy[cy] * t;
        }
        acc[k][n] += a * s;  // attn on the point's sample
      }
  }
};

// A warp-grid kernel: value, loc, attn, out, S, Q, H, D, L, P, G, the
// number of warps and the level table.
template <typename T>
using WarpGridKernel = void (*)(const T*, const float*, const float*, T*,
                                int, int, int, int, int, int, int, long long,
                                Levels);

template <typename T, bool VEC>
static int launch_warp_grid(WarpGridKernel<T> kernel, const void* value,
                            const void* loc, const void* attn, void* out,
                            int B, int S, int Q, int H, int D, int L, int P,
                            const Levels& lv, cudaStream_t stream) {
  const int G = row_lanes(D, Piece<T, VEC>::N, row_pieces(VEC));
  if (G == 0) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * H;
  const long long blocks =
      (n_warps * 32 + WARP_GRID_THREADS - 1) / WARP_GRID_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WARP_GRID_THREADS, 0, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, G, n_warps, lv);
  return (int)cudaGetLastError();
}

// One element a lane piece where a row is not a multiple of 16 bytes or
// not on a 16-byte boundary; `Kernel<T, VEC>::fn()` is the variant's
// kernel for T and VEC.
template <typename T, template <typename, bool> class Kernel>
static int launch_warp_grid_rows(const void* value, const void* loc,
                                 const void* attn, void* out, int B, int S,
                                 int Q, int H, int D, int L, int P,
                                 const Levels& lv, cudaStream_t stream) {
  if (rows_vec16<T>(value, D) && rows_vec16<T>(out, D))
    return launch_warp_grid<T, true>(Kernel<T, true>::fn(), value, loc, attn,
                                     out, B, S, Q, H, D, L, P, lv, stream);
  return launch_warp_grid<T, false>(Kernel<T, false>::fn(), value, loc, attn,
                                    out, B, S, Q, H, D, L, P, lv, stream);
}

// The C entry point of a warp-grid variant. dtype: 0 = f32, 1 = bf16,
// 2 = fp16 (value and out). hw: L pairs (h, w). TQ: the study's queries a
// block, which this grid does not tile by (checked, not used). D <= 128
// and L*P <= 64.
template <template <typename, bool> class Kernel>
static int warp_grid_entry(const void* value, const void* loc,
                           const void* attn, void* out, int dtype, int B,
                           int S, int Q, int H, int D, int L, int P, int TQ,
                           const int* hw, void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || D > MAX_ROW_D || B < 1 || Q < 1 ||
      H < 1 || P < 1 || L * P > MAX_LP || TQ < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, hw, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_warp_grid_rows<float, Kernel>(value, loc, attn, out, B, S,
                                                  Q, H, D, L, P, lv, st);
    case 1:
      return launch_warp_grid_rows<__nv_bfloat16, Kernel>(
          value, loc, attn, out, B, S, Q, H, D, L, P, lv, st);
    case 2:
      return launch_warp_grid_rows<__half, Kernel>(value, loc, attn, out, B, S,
                                                   Q, H, D, L, P, lv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
