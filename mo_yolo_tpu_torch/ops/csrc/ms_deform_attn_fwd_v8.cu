// Forward sampler, study variant v8, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v8`
// (launched by `fwd_v8`). The TPU kernel is v2's grid (batch, head, query
// tile) with three levers: the attention weight folded into the x weight,
// intermediates in the value dtype, and the point sum taken before the
// y-sum. Per (query, level), at its rounding points:
//
//   wx = relu(1 - |x - c|)*a at c = x0, x0+1 (hat form), rounded to the
//        value dtype
//   u  = (wx0*v[y, x0] + wx1*v[y, x0+1]) * relu(1 - |y - r|) in f32,
//        rounded to the value dtype, for each y row r = y0, y0+1 of a point
//   su = per y row, the sum of u over the points that touch the row, f32,
//        in point order, rounded to the value dtype
//   out = sum of the su over levels and rows in f32, rows in the order of
//        their first candidate (2p + r - y0), rounded once.
//
// The products are kept apart from the sums (`__fmul_rn`, `__fadd_rn`), so
// nvcc fuses no rounded product into a multiply-add.
//
// What bounds it on the card: bytes (the corner rows, as the main-path
// kernel), and before them the loads a warp keeps in flight. The TPU's
// layout (head-major copies of value, loc and attn; 40 blocks at Q=600) and
// a dedupe of the 2P candidate rows repeated by every element's lane were
// what the card paid for. The design:
//
// - the grid: the main-path kernel's (`ms_deform_attn_fwd.cu`), one warp
//   per (b, q, h) on the native [B,S,H,D] value, loc and attn, writing
//   [B,Q,H*D] directly (4,800 warps at Q=600);
// - the taps: the flat loop over the L*P points, one point at a time in
//   each of 32/G sub-groups of G lanes, which load its four corner rows in
//   16-byte pieces (`Piece<T, true>`) and write the point's two rounded
//   row terms u into the warp's slots in shared memory ([L*2P, D] f32);
// - the row map, once per (q, level): lane j < 2P takes candidate j
//   (point j/2, row y0 + j%2), and `__match_any_sync` over the candidates'
//   rows gives each the mask of candidates on its row; the lowest is the
//   row's leader, and a ballot gives the level's leaders; out-of-bounds
//   rows join nothing;
// - the sums: after a `__syncwarp`, each lane owns elements d = lane,
//   lane + 32, ...: per level and leader in candidate order it adds its
//   row's u in point order, rounds, and adds that to its f32 output; then
//   it stores the element. No lane holds more than one row sum at a time.
//
// loc and attn are loaded once per warp with coalesced loads and handed
// out by shuffles (`WarpPoints`); the level table is read with constant
// indices (`level_at`). A row that is not a multiple of 16 bytes, or not on
// a 16-byte boundary, takes the same kernel with one element a lane piece
// (`Piece<T, false>`). TQ, the study's queries a block, does not tile this
// grid: it is checked and otherwise unused.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define MAX_WARPS 8    // warps a block, fewer where the slots are large
#define MAX_POINTS 8   // P at most: a level's 2P candidates in 16 lanes

// Writes a lane's N row terms to its slot; 16-byte stores where N allows
// (the slot and piece offsets are then multiples of 4 floats).
template <int N>
__device__ __forceinline__ void put(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int n = 0; n < N; n += 4)
      *reinterpret_cast<float4*>(p + n) =
          make_float4(v[n], v[n + 1], v[n + 2], v[n + 3]);
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) p[n] = v[n];
  }
}

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. One warp per (b,q,h): warp index = (b*Q + q)*H + h, also
// the row of loc/attn/out it owns. G lanes carry a row, K pieces a lane.
// Shared memory: every warp's row terms [L*2P, D] f32, then every warp's
// candidate masks [L*2P] and leaders [L], one word each.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    fwd_v8_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int G,
                  long long n_warps, Levels lv) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N;
  extern __shared__ float smem[];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long warp = (long long)blockIdx.x * warps + wib;
  if (warp >= n_warps) return;  // whole warps leave together
  const int h = (int)(warp % H);
  const long long b = warp / H / Q;
  const int LP = L * P, C = 2 * P, LC = L * C;
  float* terms = smem + (size_t)wib * LC * D;  // [L*2P, D]
  unsigned* mates = reinterpret_cast<unsigned*>(smem + (size_t)warps * LC * D)
                    + wib * (LC + L);
  unsigned* leads = mates + LC;
  WarpPoints pts;
  pts.load(loc + warp * LP * 2, attn + warp * LP, LP, lane);
  const int group = lane / G, n_groups = 32 / G, sl = lane & (G - 1);
  const long long row = (long long)H * D;  // elements between rows of S
  const T* vb = value + b * S * row + (long long)h * D;

  // the row terms u of every point, a sub-group a point
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
    if (!live) continue;  // no shuffle below
    const float x = pixel(lx, wl), y = pixel(ly, hl);
    const float x0 = floorf(x), y0 = floorf(y);
    // the x weights with attn, rounded; a tap outside is skipped
    float wx[2];
#pragma unroll
    for (int cx = 0; cx < 2; ++cx)
      wx[cx] = round_to<T>(__fmul_rn(hat(x, x0 + (float)cx), a));
    const int l = i / P, p = i - l * P;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const float hy = hat(y, y0 + (float)cy);
      float* slot = terms + (size_t)(l * C + 2 * p + cy) * D;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = piece_at<N>(sl, k, G);
        if (e >= D) continue;
        float u[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float t = 0.f;
#pragma unroll
          for (int cx = 0; cx < 2; ++cx)
            if (cn.ok[2 * cy + cx])
              t = __fadd_rn(t, __fmul_rn(wx[cx], v[2 * cy + cx][k][n]));
          u[n] = round_to<T>(__fmul_rn(t, hy));
        }
        put<N>(slot + e, u);
      }
    }
  }

  // the row map: lane j < 2P is candidate j of level l; the mask of the
  // candidates on its row, 0 where the row is outside the level, and the
  // level's leaders, the lowest candidate of each row
  for (int l = 0; l < L; ++l) {
    const bool cand = lane < C;
    const int p = cand ? lane >> 1 : 0;
    const float ly =
        WarpPoints::pick(pts.loc, pts.n_loc, 2 * (l * P + p) + 1);
    int hl, wl;
    long long first;
    level_at(lv, l, hl, wl, first);
    const float fy = floorf(pixel(ly, hl)) + (float)(lane & 1);
    const bool ok = cand && inside(fy, hl);
    const unsigned same =
        __match_any_sync(0xffffffffu, ok ? (int)fy : -1 - lane);
    if (cand) mates[l * C + lane] = ok ? same : 0u;
    const unsigned lead =
        __ballot_sync(0xffffffffu, ok && __ffs(same) - 1 == lane);
    if (lane == 0) leads[l] = lead;
  }
  __syncwarp();

  // per element: the point sum of each row, rounded, then the y-sum
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const float* lvl = terms + (size_t)l * C * D + d;
      for (unsigned ld = leads[l]; ld != 0u; ld &= ld - 1u) {
        const int c = __ffs(ld) - 1;
        const unsigned m = mates[l * C + c];
        float su = lvl[(size_t)c * D];
        for (unsigned r = m & (m - 1u); r != 0u; r &= r - 1u)
          su = __fadd_rn(su, lvl[(size_t)(__ffs(r) - 1) * D]);
        acc = __fadd_rn(acc, round_to<T>(su));
      }
    }
    out[warp * D + d] = from_f32<T>(acc);
  }
}

template <typename T, bool VEC, int K>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int B, int S, int Q, int H, int D, int L, int P,
                  const Levels& lv, cudaStream_t stream) {
  const int G = row_lanes(D, Piece<T, VEC>::N, K);
  if (G == 0) return (int)cudaErrorInvalidValue;
  const size_t per_warp = ((size_t)L * 2 * P * (D + 1) + L) * sizeof(float);
  const size_t fit = MAX_DYNAMIC_SMEM / per_warp;
  const int warps = fit < MAX_WARPS ? (int)fit : MAX_WARPS;
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_v8_kernel<T, VEC, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_warps = (long long)B * Q * H;
  const long long blocks = (n_warps + warps - 1) / warps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  fwd_v8_kernel<T, VEC, K><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, G, n_warps, lv);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rows(const void* value, const void* loc, const void* attn,
                       void* out, int B, int S, int Q, int H, int D, int L,
                       int P, const Levels& lv, cudaStream_t stream) {
  if (rows_vec16<T>(value, D))
    return launch<T, true, row_pieces(true)>(value, loc, attn, out, B, S, Q,
                                             H, D, L, P, lv, stream);
  return launch<T, false, row_pieces(false)>(value, loc, attn, out, B, S, Q,
                                             H, D, L, P, lv, stream);
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: the study's queries a block (checked, not used). D <= 128, P <= 8,
// L*P <= 64; all operands in their own layout, as above.
extern "C" int ms_deform_attn_fwd_v8(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || D > MAX_ROW_D || B < 1 || Q < 1 ||
      H < 1 || P < 1 || P > MAX_POINTS || L * P > MAX_LP || TQ < 1)
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
