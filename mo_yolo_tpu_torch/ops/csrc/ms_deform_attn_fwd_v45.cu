// Forward sampler, study variants v4 and v5, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v45`
// (launched by `_fwd_like_v0` through `fwd_v4`; v4 with `compact_cy`, v5
// without). It computes the sampler's function with what v4/v5 study: the
// intermediates held in the value dtype. Per level and point, at the TPU
// kernel's rounding points:
//
//   wx = (1 - tx)*a and tx*a, rounded to the value dtype (one-hot form)
//   wy = 1 - ty and ty, rounded to the value dtype
//   t  = wx0*v[y, x0] + wx1*v[y, x0+1] in f32, rounded to the value dtype
//   u  = t*wy, a product in the value dtype
//   s  = u(y0) + u(y0+1) in f32, rounded to the value dtype
//   out = sum over levels of (sum over points of s) in f32, rounded once.
//
// On the card the lever is packed arithmetic: a lane carries two
// neighbouring elements of a row, and u is one `__hmul2` on a
// `__nv_bfloat162` (correctly rounded, as the TPU's product in bf16).
// v4 builds the y weights compact on the TPU ([R, Hl], expanded by a
// product); here the first lane of a pair's row computes a tap's y weights
// and a shuffle hands them to the row's other lanes (`compact_cy` = 1). v5
// builds them at full width on the TPU; here every lane computes its own
// (`compact_cy` = 0). Both give the same values.
//
// What bounds it on the card: the grid, then bytes. The skeleton is the TPU
// kernel's grid (`walk_pairs` in sampler_common.cuh): one block of 1024
// threads per (batch, query tile) with all heads, loc and attn staged in
// shared memory, warps over (q, h) pairs. At D=32 a row is 16 lanes of two
// elements, so a warp carries two pairs at once instead of leaving half its
// lanes idle. Ten blocks at Q=600, TQ=64 leave most of the 132 SMs idle.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 1024

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. D even, at most 64; G = pair_lanes(D).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_v45_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                   const float* __restrict__ attn, T* __restrict__ out,
                   int S, int Q, int H, int D, int L, int P, int TQ, int G,
                   int compact_cy, Levels lv) {
  const int leader = (threadIdx.x & 31) & ~(G - 1);  // the row's first lane
  const bool computes_y = !compact_cy || (threadIdx.x & 31) == leader;
  walk_pairs<T>(value, loc, attn, out, S, Q, H, D, L, P, TQ, G,
                [&](const float* lp, const float* ap, const T* vb,
                    long long row, bool live) {
    float2 acc = make_float2(0.f, 0.f);
    for (int l = 0; l < L; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const T* vl = vb + lv.start[l] * row;
      float2 lvl = make_float2(0.f, 0.f);
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float x = pixel(lp[2 * i], wl);
        const float x0 = floorf(x), tx = x - x0;
        const float wx0 = round_to<T>((1.f - tx) * ap[i]);
        const float wx1 = round_to<T>(tx * ap[i]);
        float y0 = 0.f, wy0 = 0.f, wy1 = 0.f;
        if (computes_y) {
          const float y = pixel(lp[2 * i + 1], hl);
          y0 = floorf(y);
          wy0 = round_to<T>(1.f - (y - y0));
          wy1 = round_to<T>(y - y0);
        }
        if (compact_cy) {  // uniform across the block
          y0 = __shfl_sync(0xffffffffu, y0, leader);
          wy0 = __shfl_sync(0xffffffffu, wy0, leader);
          wy1 = __shfl_sync(0xffffffffu, wy1, leader);
        }
        float2 s = make_float2(0.f, 0.f);
#pragma unroll
        for (int cy = 0; cy < 2; ++cy) {
          const float fy = y0 + (float)cy;
          if (!live || !inside(fy, hl)) continue;
          const T* vr = vl + (long long)fy * wl * row;
          float2 t = make_float2(0.f, 0.f);
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            const float fx = x0 + (float)cx;
            if (!inside(fx, wl)) continue;
            const float w = cx ? wx1 : wx0;
            const float2 v = Pair<T>::load(vr + (long long)fx * row);
            t.x += w * v.x;
            t.y += w * v.y;
          }
          const float2 u = Pair<T>::mul(t, cy ? wy1 : wy0);
          s.x += u.x;
          s.y += u.y;
        }
        s = Pair<T>::round(s);  // the y-sum in the value dtype
        lvl.x += s.x;
        lvl.y += s.y;
      }
      acc.x += lvl.x;
      acc.y += lvl.y;
    }
    return acc;
  });
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int B, int S, int Q, int H, int D, int L, int P,
                  int TQ, int compact_cy, const Levels& lv,
                  cudaStream_t stream) {
  const int G = pair_lanes(D);
  const size_t smem = (size_t)TQ * H * L * P * 3 * sizeof(float);
  if (G == 0 || smem > MAX_DYNAMIC_SMEM ||
      (uintptr_t)value % (2 * sizeof(T)) != 0 ||
      (uintptr_t)out % (2 * sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_v45_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + TQ - 1) / TQ, B);
  fwd_v45_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, TQ, G, compact_cy, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: queries per block. compact_cy: 1 for v4, 0 for v5. D even, at most
// 64; value and out aligned to two elements.
extern "C" int ms_deform_attn_fwd_v45(const void* value, const void* loc,
                                      const void* attn, void* out, int dtype,
                                      int B, int S, int Q, int H, int D,
                                      int L, int P, int TQ, int compact_cy,
                                      const int* hw, void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || B < 1 || B > 65535 || Q < 1 ||
      H < 1 || P < 1 || TQ < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, hw, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ,
                           compact_cy, lv, st);
    case 1:
      return launch<__nv_bfloat16>(value, loc, attn, out, B, S, Q, H, D, L, P,
                                   TQ, compact_cy, lv, st);
    case 2:
      return launch<__half>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ,
                            compact_cy, lv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
