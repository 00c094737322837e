// Forward sampler, study ablation nocy, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_nocy`
// (launched by `_fwd_like_v0` through `fwd_nocy`). It is wrong on purpose:
// the TPU kernel is v0 without the y interpolation, timed to see what the
// y-mask build costs there. It computes, per level and point,
//
//   wx = (1 - tx)*a and tx*a, rounded to the value dtype (one-hot form)
//   s  = sum over ALL Hl rows y of (wx0*v[y, x0] + wx1*v[y, x0+1]), in f32
//
// and out = sum over levels and points of s in f32, rounded once. No y
// weight at all: a point reads the whole two columns of its level.
//
// What bounds it on the card: bytes. A column's sum over its Hl rows is the
// same for every tap that touches it, so the function needs each touched
// column read once (12.7 MB at 1536x800 bf16), plus loc, attn and out.
// What the design does: two launches in one C call, on an f32 workspace
// that the wrapper allocates.
//
// - column sums: colsum[b, h, c, :] = sum_y v[b, start_l + y*W_l + x, h, :]
//   in f32, for every column c = (l, x) of every level (sum_l W_l columns
//   a stream: 336 at 1536x800, a 344 KB workspace). One block a column and
//   stream; its warps split the column's rows, each lane carries 16 bytes
//   of a pixel's H*D row (`Piece`), and the warps' partial sums meet in
//   shared memory. So value is read once, whole and coalesced.
// - a two-tap 1-D sampler over the column sums on K1's grid and sub-group
//   layout (`ms_deform_attn_fwd.cu`): one warp per (b, q, h), loc and attn
//   handed out by shuffles, a sub-group of G lanes per point reading its
//   two f32 column-sum rows with 16-byte loads; the x weights are rounded
//   to the value dtype as before, the sums are f32, the output is rounded
//   once.
//
// Only the order of the f32 sum changes (over y first, then the taps); the
// TPU kernel's own sum over Hl is an MXU dot, whose order was never
// sequential.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after each launch.

#include "sampler_common.cuh"

#define COL_THREADS 256     // 8 warps split a column's rows
#define SAMPLE_THREADS 256  // 8 warps, one (b, q, h) each

// value [B,S,H,D] -> colsum [B,H,CW,D] f32, CW = sum_l W_l. Block
// (c, b); `cl` is the column table: cl.start[l] is level l's first column.
template <typename T, bool VEC>
__global__ void __launch_bounds__(COL_THREADS)
    nocy_colsum_kernel(const T* __restrict__ value, float* __restrict__ colsum,
                       int S, int H, int D, int L, int CW, Levels lv,
                       Levels cl) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N;
  constexpr int WARPS = COL_THREADS / 32;
  __shared__ float part[WARPS][32 * N];
  const int c = blockIdx.x;
  const long long b = blockIdx.y;
  int l = 0;
#pragma unroll
  for (int j = 1; j < MAX_LEVELS; ++j)
    if (j < L && c >= cl.start[j]) l = j;
  int hl, wl;
  long long col0, first;
  level_at(cl, l, hl, wl, col0);
  level_at(lv, l, hl, wl, first);
  const int HD = H * D;
  const T* col = value + (b * S + first + (c - col0)) * HD;
  const long long pitch = (long long)wl * HD;  // elements between rows y
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_pieces = HD / N;
  for (int p0 = 0; p0 < n_pieces; p0 += 32) {
    const int p = p0 + lane;
    float acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
    if (p < n_pieces) {
#pragma unroll 4
      for (int y = warp; y < hl; y += WARPS) {
        float v[N];
        R::load(col + y * pitch + p * N, v);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] += v[n];
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) part[warp][lane * N + n] = acc[n];
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * N; t += COL_THREADS) {
      const int e = p0 * N + t;  // element of the pixel's H*D row
      if (e < HD) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += part[w][t];
        const int h = e / D, d = e - h * D;
        colsum[((b * H + h) * CW + c) * D + d] = s;
      }
    }
    __syncthreads();
  }
}

// colsum [B,H,CW,D] f32; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. One warp per (b,q,h): warp index = (b*Q + q)*H + h, also
// the row of loc/attn/out it owns. G lanes carry a column-sum row, K
// pieces a lane.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(SAMPLE_THREADS)
    nocy_sample_kernel(const float* __restrict__ colsum,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn, T* __restrict__ out,
                       int Q, int H, int D, int L, int P, int G, int CW,
                       long long n_warps, Levels cl) {
  using R = Piece<float, VEC>;
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
  const float* cb = colsum + (b * H + h) * (long long)CW * D;

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
    long long col0;
    level_at(cl, (live ? i : 0) / P, hl, wl, col0);
    const float x = pixel(lx, wl);
    const float x0 = floorf(x), tx = x - x0;
    // the one-hot x weights times a, rounded to the value dtype
    const float wx[2] = {round_to<T>((1.f - tx) * a), round_to<T>(tx * a)};
#pragma unroll
    for (int cx = 0; cx < 2; ++cx) {
      const float fx = x0 + (float)cx;
      // the float bounds test before the index: NaN or inf fall outside
      const bool ok = live && inside(fx, wl);
      const float* row = cb + (col0 + (ok ? (long long)fx : 0)) * D;
      const float w = ok ? wx[cx] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = piece_at<N>(sl, k, G);
        if (ok && e < D) {
          float v[N];
          R::load(row + e, v);
#pragma unroll
          for (int n = 0; n < N; ++n) acc[k][n] += w * v[n];
        }
      }
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
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (e + n < D) out[warp * D + e + n] = from_f32<T>(acc[k][n]);
    }
  }
}

template <typename T, bool VEC, int K>
static int launch_sample(const float* colsum, const void* loc,
                         const void* attn, void* out, int B, int Q, int H,
                         int D, int L, int P, int CW, const Levels& cl,
                         cudaStream_t stream) {
  const int G = row_lanes(D, Piece<float, VEC>::N, K);
  if (G == 0) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Q * H;
  const long long blocks = (n_warps * 32 + SAMPLE_THREADS - 1) /
                           SAMPLE_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  nocy_sample_kernel<T, VEC, K>
      <<<(unsigned)blocks, SAMPLE_THREADS, 0, stream>>>(
          colsum, (const float*)loc, (const float*)attn, (T*)out, Q, H, D, L,
          P, G, CW, n_warps, cl);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, float* ws, int B, int S, int Q, int H, int D,
                  int L, int P, const Levels& lv, cudaStream_t stream) {
  // the column table: level l's columns start at cl.start[l]
  Levels cl = lv;
  int CW = 0;
  for (int l = 0; l < L; ++l) {
    cl.start[l] = CW;
    CW += lv.w[l];
  }
  const dim3 grid(CW, B);
  if (rows_vec16<T>(value, H * D))
    nocy_colsum_kernel<T, true><<<grid, COL_THREADS, 0, stream>>>(
        (const T*)value, ws, S, H, D, L, CW, lv, cl);
  else
    nocy_colsum_kernel<T, false><<<grid, COL_THREADS, 0, stream>>>(
        (const T*)value, ws, S, H, D, L, CW, lv, cl);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // column-sum rows are D floats from a 16-byte boundary: 16-byte pieces
  // when D is a multiple of 4
  if (D % 4 == 0)
    return launch_sample<T, true, 1>(ws, loc, attn, out, B, Q, H, D, L, P,
                                     CW, cl, stream);
  return launch_sample<T, false, 2>(ws, loc, attn, out, B, Q, H, D, L, P, CW,
                                    cl, stream);
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). ws: the column sums,
// B*H*(sum_l W_l)*D floats on a 16-byte boundary. hw: L pairs (h, w).
// TQ: the study's queries a block, which this design does not tile by; it
// is checked and otherwise unused. D even, at most 64 (the rule the
// study's interface keeps); L*P at most 64.
extern "C" int ms_deform_attn_fwd_nocy(const void* value, const void* loc,
                                       const void* attn, void* out, void* ws,
                                       int dtype, int B, int S, int Q, int H,
                                       int D, int L, int P, int TQ,
                                       const int* hw, void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || B < 1 || B > 65535 || Q < 1 ||
      H < 1 || P < 1 || L * P > MAX_LP || TQ < 1 || D % 2 != 0 || D > 64 ||
      ((uintptr_t)ws & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, hw, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* w = (float*)ws;
  switch (dtype) {
    case 0:
      return launch<float>(value, loc, attn, out, w, B, S, Q, H, D, L, P, lv,
                           st);
    case 1:
      return launch<__nv_bfloat16>(value, loc, attn, out, w, B, S, Q, H, D, L,
                                   P, lv, st);
    case 2:
      return launch<__half>(value, loc, attn, out, w, B, S, Q, H, D, L, P, lv,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
