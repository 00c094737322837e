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
// What bounds it on the card: the column reads through few blocks. Each
// point reads Hl rows per x tap where a bilinear sample reads two, Hl/2
// times a point's rows (about 430 MB, mostly from L2, at 1536x800 with
// levels of 100, 50 and 25 rows), through v45's ten blocks at Q=600,
// TQ=64; so its time measures that column read and not the y-mask build
// the TPU ablation timed. The skeleton is v45's (`walk_pairs`): a block of
// 1024 threads per (batch, query tile), two elements a lane.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 1024

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. D even, at most 64; G = pair_lanes(D).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_nocy_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, T* __restrict__ out,
                    int S, int Q, int H, int D, int L, int P, int TQ, int G,
                    Levels lv) {
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
        if (!live || !(inside(x0, wl) || inside(x0 + 1.f, wl))) continue;
        float2 s = make_float2(0.f, 0.f);
        for (int yy = 0; yy < hl; ++yy) {
          const T* vr = vl + (long long)yy * wl * row;
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
          s.x += t.x;
          s.y += t.y;
        }
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
                  int TQ, const Levels& lv, cudaStream_t stream) {
  const int G = pair_lanes(D);
  const size_t smem = (size_t)TQ * H * L * P * 3 * sizeof(float);
  if (G == 0 || smem > MAX_DYNAMIC_SMEM ||
      (uintptr_t)value % (2 * sizeof(T)) != 0 ||
      (uintptr_t)out % (2 * sizeof(T)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_nocy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + TQ - 1) / TQ, B);
  fwd_nocy_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, TQ, G, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: queries per block. D even, at most 64; value and out aligned to two
// elements.
extern "C" int ms_deform_attn_fwd_nocy(const void* value, const void* loc,
                                       const void* attn, void* out,
                                       int dtype, int B, int S, int Q, int H,
                                       int D, int L, int P, int TQ,
                                       const int* hw, void* stream) {
  if (L < 1 || L > MAX_LEVELS || D < 1 || B < 1 || B > 65535 || Q < 1 ||
      H < 1 || P < 1 || TQ < 1)
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
      return launch<__half>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ, lv,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
