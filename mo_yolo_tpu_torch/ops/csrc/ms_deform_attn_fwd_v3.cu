// Forward sampler, study variant v3, for Hopper (sm_90a).
//
// Replaces the TPU kernel `scripts/kernel_variants_bench.py:_kernel_v3`
// (launched by `fwd_v3`). It computes the sampler's function with what v3
// studies: the levels fused into one pass. The TPU kernel stacks the levels
// into one block-diagonal table so that a (head, query tile) issues one
// product, with per-level guards so that no tap leaks into a neighbouring
// level. Here there is no table: one flat loop covers the L*P*4 taps of a
// (q, h) pair, each tap looks up its level's bounds and offset, and the
// guards are the bounds test. As in the TPU kernel the attention weight is
// folded into the x weight ((1 - tx) * a or tx * a) before the y weight.
//
// What bounds it on the card: bytes. What the design does: a row of D
// values is read by a sub-group of a warp with 16-byte loads (four lanes
// for a 64-byte bf16 row at D=32, eight for f32), so a warp has 32/G taps
// in flight (eight in bf16) where the main-path kernel has one; the
// sub-groups' partial sums meet in a shuffle reduction and sub-group 0
// writes the row with 16-byte stores. loc and attn of the tile are staged
// into shared memory; the grid is (batch, query tile), heads inside, as the
// TPU kernel's.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include "sampler_common.cuh"

#define THREADS 1024

// value [B,S,H,D]; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32;
// out [B,Q,H*D]. D is a multiple of Vec<T>::N and rows are 16-byte
// aligned. G, a power of two <= 32, is the number of lanes that carry one
// row (G * N >= D). Block (tile, b) owns queries [tile*TQ, tile*TQ + TQ).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_v3_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                  const float* __restrict__ attn, T* __restrict__ out, int S,
                  int Q, int H, int D, int L, int P, int TQ, int G,
                  Levels lv) {
  constexpr int N = Vec<T>::N;
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
  const int group = lane / G, n_groups = 32 / G;
  const int d0 = (lane & (G - 1)) * N;  // this lane's first element
  const bool live = d0 < D;
  const int n_taps = LP * 4;
  const long long row = (long long)H * D;  // elements between rows of S
  // the trip counts below depend on the warp alone, so every lane reaches
  // the shuffles
  for (int pair = warp; pair < n_pairs; pair += n_warps) {
    const int h = pair % H;  // pair = q_local * H + h
    const float* lp = s_loc + pair * LP * 2;
    const float* ap = s_attn + pair * LP;
    const T* vb = value + (long long)b * S * row + (long long)h * D + d0;
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
    for (int t0 = 0; t0 < n_taps; t0 += n_groups) {
      const int t = t0 + group;
      if (t >= n_taps || !live) continue;
      const int i = t >> 2, c = t & 3;  // i = l * P + p; corner (c&1, c>>1)
      const int l = i / P;
      const int hl = lv.h[l], wl = lv.w[l];
      const float x = pixel(lp[2 * i], wl), y = pixel(lp[2 * i + 1], hl);
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x0 + (float)(c & 1), fy = y0 + (float)(c >> 1);
      // the level's guards: a tap outside its own map adds nothing
      if (!inside(fx, wl) || !inside(fy, hl)) continue;
      const float tx = x - x0, ty = y - y0;
      const float w = (((c & 1) ? tx : 1.f - tx) * ap[i]) *
                      ((c >> 1) ? ty : 1.f - ty);
      const long long s = lv.start[l] + (long long)fy * wl + (long long)fx;
      float v[N];
      Vec<T>::load(vb + s * row, v);
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += w * v[k];
    }
    for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
    if (group == 0 && live) Vec<T>::store(out + (first + pair) * D + d0, acc);
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
  const size_t smem = (size_t)TQ * H * L * P * 3 * sizeof(float);
  if (smem > MAX_DYNAMIC_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_v3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + TQ - 1) / TQ, B);
  fwd_v3_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)value, (const float*)loc, (const float*)attn, (T*)out, S, Q,
      H, D, L, P, TQ, G, lv);
  return (int)cudaGetLastError();
}

// dtype: 0 = f32, 1 = bf16, 2 = fp16 (value and out). hw: L pairs (h, w).
// TQ: queries per block. D*sizeof(value type) must be a multiple of 16 and
// at most 512; value and out 16-byte aligned.
extern "C" int ms_deform_attn_fwd_v3(const void* value, const void* loc,
                                     const void* attn, void* out, int dtype,
                                     int B, int S, int Q, int H, int D, int L,
                                     int P, int TQ, const int* hw,
                                     void* stream) {
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
      return launch<__half>(value, loc, attn, out, B, S, Q, H, D, L, P, TQ,
                            lv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
