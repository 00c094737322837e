// Forward sampler, study variant v7, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v7`
// (launched by `fwd_v7`). The TPU kernel is v3's arithmetic (the levels
// fused into one block-diagonal pass, per-level guards) on v2's grid
// (batch, head, query tile), with the same rounding points as v3:
//
//   wx = (1 - tx)*a and tx*a, guarded, rounded to the value dtype
//   wy = 1 - ty and ty, guarded, f32
//   u  = (wx0*v[y, x0] + wx1*v[y, x0+1]) * wy in f32, rounded to the value
//        dtype
//   s  = sum over the levels and y taps of one point's u, in f32, rounded
//        to the value dtype
//   out = sum over the points of s in f32, rounded once.
//
// On the card that is a sub-group warp on the TPU kernel's grid (batch,
// head, query tile): a row of D values is read by G lanes with 16-byte
// loads (four lanes for a 64-byte bf16 row at D=32), so a warp has 32/G
// sub-groups; the guards are the bounds test. The rounding point s is per
// point, so the sub-groups split the points: gpp sub-groups share a point
// (the largest power of two with gpp*P <= 32/G, two at D=32 bf16), each
// takes every gpp-th (level, y tap) of it, two 16-byte loads each; a
// shuffle sums the point's sub-groups, one of them adds s rounded, and a
// last shuffle sums the points. The wrapper makes value [B,H,S,D] and
// loc and attn [B,H,Q,...], as v2's does, and transposes the [B,H,Q,D]
// output back; those transposes are part of the variant and of its time.
//
// What bounds it on the card: bytes, once there are blocks enough: 80
// blocks at Q=600, TQ=64 (40 at 128; 24 at 256), eight taps in flight a
// warp in bf16.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 512

// value [B,H,S,D]; loc [B,H,Q,L,P,2] f32; attn [B,H,Q,L,P] f32;
// out [B,H,Q,D]. D is a multiple of Vec<T>::N and rows are 16-byte
// aligned. G, a power of two <= 32, is the number of lanes that carry one
// row (G * N >= D). Block (tile, h, b) owns queries [tile*TQ, tile*TQ + TQ)
// of head h.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_v7_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int TQ, int G,
                  Levels lv) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  const int LP = L * P;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, Q - q0);  // the last tile may be partial
  float* s_loc = smem;                       // [nq, L, P, 2]
  float* s_attn = smem + (size_t)TQ * LP * 2;  // [nq, L, P]
  const long long slab = (long long)b * H + h;
  const long long first = slab * Q + q0;  // first query row of the tile
  stage(s_loc, loc + first * LP * 2, nq * LP * 2);
  stage(s_attn, attn + first * LP, nq * LP);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int group = lane / G, n_groups = 32 / G;
  int gpp = 1;  // sub-groups a point
  while (2 * gpp * P <= n_groups) gpp *= 2;
  const int k = group % gpp;              // this sub-group's share of a point
  const int per_round = n_groups / gpp;   // points a round
  const int d0 = (lane & (G - 1)) * N;    // this lane's first element
  const bool live = d0 < D;
  const int n_units = 2 * L;              // (level, y tap) pairs of a point
  const T* vb = value + slab * S * D + d0;
  // the trip counts below that hold a shuffle depend on the warp alone, so
  // every lane reaches the shuffles
  for (int q = warp; q < nq; q += n_warps) {
    const float* lp = s_loc + q * LP * 2;
    const float* ap = s_attn + q * LP;
    float acc[N];
#pragma unroll
    for (int kk = 0; kk < N; ++kk) acc[kk] = 0.f;
    for (int p0 = 0; p0 < P; p0 += per_round) {
      const int p = p0 + group / gpp;
      float s[N];
#pragma unroll
      for (int kk = 0; kk < N; ++kk) s[kk] = 0.f;
      for (int j = k; live && p < P && j < n_units; j += gpp) {
        const int l = j >> 1, cy = j & 1, i = l * P + p;
        const int hl = lv.h[l], wl = lv.w[l];
        const float x = pixel(lp[2 * i], wl), y = pixel(lp[2 * i + 1], hl);
        const float x0 = floorf(x), y0 = floorf(y);
        const float fy = y0 + (float)cy;
        // the level's guards: a tap outside its own map adds nothing
        if (!inside(fy, hl)) continue;
        const float tx = x - x0, ty = y - y0;
        const float wy = cy ? ty : 1.f - ty;
        const T* vr = vb + (lv.start[l] + (long long)fy * wl) * D;
        float t[N];
#pragma unroll
        for (int kk = 0; kk < N; ++kk) t[kk] = 0.f;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const float fx = x0 + (float)cx;
          if (!inside(fx, wl)) continue;
          const float w = round_to<T>((cx ? tx : 1.f - tx) * ap[i]);
          float v[N];
          Vec<T>::load(vr + (long long)fx * D, v);
#pragma unroll
          for (int kk = 0; kk < N; ++kk) t[kk] += w * v[kk];
        }
#pragma unroll
        for (int kk = 0; kk < N; ++kk) s[kk] += round_to<T>(t[kk] * wy);
      }
      // the point's sub-groups meet; s is rounded before the point sum
      for (int off = G; off < G * gpp; off <<= 1) {
#pragma unroll
        for (int kk = 0; kk < N; ++kk)
          s[kk] += __shfl_xor_sync(0xffffffffu, s[kk], off);
      }
      if (k == 0 && p < P) {
#pragma unroll
        for (int kk = 0; kk < N; ++kk) acc[kk] += round_to<T>(s[kk]);
      }
    }
    // the point sum across the sub-groups that hold a point's s
    for (int off = G * gpp; off < 32; off <<= 1) {
#pragma unroll
      for (int kk = 0; kk < N; ++kk)
        acc[kk] += __shfl_xor_sync(0xffffffffu, acc[kk], off);
    }
    if (group == 0 && live) Vec<T>::store(out + (first + q) * D + d0, acc);
  }
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int B, int S, int Q, int H, int D, int L, int P,
                  int TQ, const Levels& lv, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  if (D % N != 0 || D / N > 32 || ((uintptr_t)value & 15) != 0 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G * N < D) G *= 2;
  const size_t smem = (size_t)TQ * L * P * 3 * sizeof(float);
  if (smem > MAX_DYNAMIC_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_v7_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + TQ - 1) / TQ, H, B);
  fwd_v7_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, TQ, G, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: queries per block. All operands head-major, as above.
// D*sizeof(value type) must be a multiple of 16 and at most 512; value and
// out 16-byte aligned.
extern "C" int ms_deform_attn_fwd_v7(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || B < 1 || B > 65535 || Q < 1 ||
      H < 1 || H > 65535 || P < 1 || TQ < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, hw, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ, lv,
                           st);
    case 1:
      return launch<__nv_bfloat16>(value, loc, attn, out, B, S, Q, H, D, L, P,
                                   TQ, lv, st);
    case 2:
      return launch<__half>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ,
                            lv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
