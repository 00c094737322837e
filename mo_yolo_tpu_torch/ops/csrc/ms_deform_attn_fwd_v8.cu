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
//        rounded to the value dtype
//   out = sum over levels and rows of su in f32, rounded once.
//
// With P points a (query, level) touches at most 2P rows, and points that
// share a row are summed before the rounding, as the TPU kernel's point-sum
// product does: each lane keeps the 2P candidate rows and their u in
// registers, adds a candidate into the first one with the same row, and
// then sums the rounded first ones.
//
// What bounds it on the card: bytes, with v2's parallelism. The skeleton is
// v2's kernel (`ms_deform_attn_fwd_v2.cu`): head-major operands made by the
// wrapper (their transposes are part of the variant and of its time), the
// tile's loc and attn staged in shared memory, warps over queries, lanes
// over D. Blocks: 80 at Q=600, TQ=64; 40 at the default TQ=128.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 512
#define MAX_POINTS 8  // P at most; 2P candidate rows held in registers

// value [B,H,S,D]; loc [B,H,Q,L,P,2] f32; attn [B,H,Q,L,P] f32;
// out [B,H,Q,D]. Block (tile, h, b) owns queries [tile*TQ, tile*TQ + TQ)
// of head h.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_v8_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int TQ, Levels lv) {
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
  const T* vb = value + slab * S * D;
  for (int q = warp; q < nq; q += n_warps) {
    const float* lp = s_loc + q * LP * 2;
    const float* ap = s_attn + q * LP;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const int hl = lv.h[l], wl = lv.w[l];
        const T* vl = vb + lv.start[l] * D + d;
        int rows[2 * MAX_POINTS];  // candidate c = 2p + cy; -1: none
        float u[2 * MAX_POINTS];
#pragma unroll
        for (int c = 0; c < 2 * MAX_POINTS; ++c) {
          rows[c] = -1;
          u[c] = 0.f;
        }
#pragma unroll
        for (int p = 0; p < MAX_POINTS; ++p) {
          if (p >= P) break;
          const int i = l * P + p;
          const float x = pixel(lp[2 * i], wl), y = pixel(lp[2 * i + 1], hl);
          const float x0 = floorf(x), y0 = floorf(y);
#pragma unroll
          for (int cy = 0; cy < 2; ++cy) {
            const float fy = y0 + (float)cy;
            if (!inside(fy, hl)) continue;
            float t = 0.f;
#pragma unroll
            for (int cx = 0; cx < 2; ++cx) {
              const float fx = x0 + (float)cx;
              if (!inside(fx, wl)) continue;
              const float w = round_to<T>(hat(x, fx) * ap[i]);
              t += w * to_f32(vl[((long long)fy * wl + (long long)fx) * D]);
            }
            rows[2 * p + cy] = (int)fy;
            u[2 * p + cy] = round_to<T>(t * hat(y, fy));
          }
        }
        // the point sum per row: a candidate joins the first one with its
        // row, in point order
#pragma unroll
        for (int c = 1; c < 2 * MAX_POINTS; ++c) {
#pragma unroll
          for (int e = 0; e < c; ++e) {
            if (rows[c] >= 0 && rows[e] == rows[c]) {
              u[e] += u[c];
              rows[c] = -1;
              break;
            }
          }
        }
        // then the y-sum of the rounded row sums
#pragma unroll
        for (int c = 0; c < 2 * MAX_POINTS; ++c)
          if (rows[c] >= 0) acc += round_to<T>(u[c]);
      }
      out[(first + q) * D + d] = from_f32<T>(acc);
    }
  }
}

template <typename T>
static int launch(const void* value, const void* loc, const void* attn,
                  void* out, int B, int S, int Q, int H, int D, int L, int P,
                  int TQ, const Levels& lv, cudaStream_t stream) {
  const size_t smem = (size_t)TQ * L * P * 3 * sizeof(float);
  if (P > MAX_POINTS || smem > MAX_DYNAMIC_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_v8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + TQ - 1) / TQ, H, B);
  fwd_v8_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, TQ, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: queries per block. P at most 8. All operands head-major, as above.
extern "C" int ms_deform_attn_fwd_v8(const void* value, const void* loc,
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
