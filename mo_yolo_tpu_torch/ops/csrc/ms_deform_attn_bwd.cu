// Multi-scale deformable-attention backward (the sampler's gradient) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `mo_yolo_tpu/ops/deform_attn_pallas.py:_bwd_kernel`
// (launched by `_backward`). Given g = d out [B,Q,H*D] it returns
//
//   d_value[b,s,h,:] = sum over (q,l,p,corner) landing on s of g*attn*w_corner
//   d_attn[b,q,h,l,p] = sum_corner w_corner * <g, v_corner>
//   d_loc[b,q,h,l,p]  = (W_l * dL/dtx, H_l * dL/dty), the derivatives of the
//                       bilinear weights against attn * <g, v_corner>
//
// with no contribution from corners outside the map. The TPU kernel runs its
// grid in order and carries d_value across query tiles in VMEM, so it sums
// a row's terms in a fixed sequence. On Hopper the blocks run in no order,
// and nothing carries from one to the next.
//
// What bounds it on the card: bytes. The function reads the value rows the
// corners touch, g, loc and attn once and writes d_value [B,S,H,D] (12.9 MB
// in bf16 at 1536x800), d_loc and d_attn once. The design writes every
// d_value row exactly once, in the output dtype, with no float atomics, no
// zeroed f32 buffer and no cast pass. It sorts the corners by the d_value
// row they land on and, within a row, by slot, and sums each row's corners
// in one place in that order, so d_value is the same bit for bit in every
// run:
//
// 1. dots: one warp per (b,q,h) on K1's grid and with K1's warp (sub-groups
//    of G lanes carry a corner row with 16-byte loads, the four corners of
//    a point at a time). It computes <g, v_corner>, d_attn and d_loc, and
//    for each of the warp's L*P*4 corner slots c writes key[c], the
//    d_value row (b*S + s)*H + h in d_value's own order (-1 outside the
//    map) and aw[c] = attn*wx*wy, and counts the row with an integer
//    atomic whose result it does not wait for.
// 2. tile_sums and scan: the exclusive prefix sum of the B*S*H counts,
//    start[], in two launches (per-tile sums; then each tile adds the sums
//    before it and scans itself). A row with no corner is written as zeros
//    here, without reading g, by the block's threads side by side.
// 3. place: each in-bounds slot c takes a place in its row's list from an
//    integer atomic on the row's cursor and writes there a 16-byte record
//    (c, key[c], aw[c]): the lists in row order, each in the order the
//    atomics handed out places, which changes from run to run.
// 4. sort: each list is put in ascending slot order. A point's four corners
//    are four pixels, so a row (b, s, h) holds at most one corner of each
//    point (q, p) of its level: at most Q*P records, with distinct
//    u = q*P + p, which orders them as c does. A block takes a tile of
//    SORT_TILE places. A record of a row of at most SHORT_ROW records is
//    ranked by counting the smaller slots of its row; a longer row
//    (clustered corners make rows of hundreds) is taken whole by the block
//    where its list starts: each record sets bit u of the row's bit set in
//    shared memory, and its rank is the bits before its own. Each record
//    is written once at its rank; nothing depends on the order threads run.
// 5. reduce: the sorted slots are cut into chunks of CHUNK, a sub-group per
//    chunk, so the work is even however the corners cluster (training
//    queries gather on a few objects, and a row can collect hundreds of
//    corners). A sub-group reads its chunk's records in one round and
//    sums g[c / (L*P*4)] * aw[c] in f32 while the row stays the same, and
//    writes a row that lies wholly in the chunk once, in the output dtype,
//    with 16-byte stores. The pieces of a row that crosses chunk edges
//    meet in the block's shared memory, where the sub-group that holds the
//    row's start sums them in chunk order; only a row that runs past the
//    block's chunks leaves an f32 carry.
// 6. fixup: the block where such a row starts adds the carries of the
//    blocks it runs into, in block order (a block sums 1,024 slots for a
//    bf16 row at D=32, so even a row of thousands of corners spans a few),
//    and writes it.
//
// Same-address atomics serialize in L2, so corners that pile onto a few
// rows slow dots and place (PERF.md has the numbers; counting a block's
// rows in shared memory first fixed that, but cost more on spread-out
// corners than it saved on clustered ones, and was left out).
//
// A row that is not a multiple of 16 bytes, or not on a 16-byte boundary,
// takes the same kernels with one element a lane piece.
//
// Plain C entry points, bound with ctypes, the shapes as one int block
// (`Dims`): `ms_deform_attn_bwd_workspace` gives the scratch layout for a
// shape, `ms_deform_attn_bwd` launches every stage on the caller's stream
// and returns cudaGetLastError() after them.

#include <limits.h>

#include "sampler_common.cuh"

#define THREADS 256   // 8 warps a block
#define SCAN_ITEMS 4  // counts a scan thread holds
#define SCAN_TILE (THREADS * SCAN_ITEMS)
#define CHUNK 16      // sorted slots a reduce sub-group sums

// --------------------------------------------------------------- 1. dots

// value/grad in T; loc [B,Q,H,L,P,2] f32; attn [B,Q,H,L,P] f32; dloc,
// dattn f32 in the layouts of loc and attn; key, aw [B*Q*H*L*P*4]; counts
// [B*S*H], zeroed. One warp per (b,q,h): warp index (b*Q + q)*H + h is
// also the row of loc/attn/grad/dloc/dattn it owns. G lanes carry a row,
// K pieces a lane.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(THREADS)
    bwd_dots_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ attn, const T* __restrict__ grad,
                    float* __restrict__ dloc, float* __restrict__ dattn,
                    int* __restrict__ key, float* __restrict__ aw,
                    int* __restrict__ counts, int S, int Q, int H, int D,
                    int L, int P, int G, long long n_warps, Levels lv) {
  using R = Piece<T, VEC>;
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
  const long long row = (long long)H * D;  // elements between rows of S
  const T* vb = value + b * S * row + (long long)h * D;

  float gv[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = piece_at<N>(sl, k, G);
    if (e < D) {
      R::load(grad + warp * D + e, gv[k]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) gv[k][n] = 0.f;
    }
  }
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
    const T* vl = vb + first * row;
    // the four corner rows' loads first, then their dot products
    float v[4][K][N];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = piece_at<N>(sl, k, G);
        if (cn.ok[c] && e < D) {
          R::load(vl + cn.s[c] * row + e, v[c][k]);
        } else {
#pragma unroll
          for (int n = 0; n < N; ++n) v[c][k][n] = 0.f;
        }
      }
    float dot[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int n = 0; n < N; ++n) part += gv[k][n] * v[c][k][n];
      dot[c] = part;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      for (int off = G >> 1; off > 0; off >>= 1)
        dot[c] += __shfl_xor_sync(0xffffffffu, dot[c], off);
    const long long pt = warp * LP + i;
    // corner c's slot is written by lane c of the sub-group (all four by
    // the lanes there are when G < 4)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!live || (c & (G - 1)) != sl) continue;
      const int r =
          cn.ok[c] ? (int)(((b * S) + first + cn.s[c]) * H + h) : -1;
      const long long slot = pt * 4 + c;
      key[slot] = r;
      aw[slot] = a * (cn.wx(c) * cn.wy(c));
      if (r >= 0) atomicAdd(counts + r, 1);  // the result is not waited for
    }
    if (!live || sl != 0) continue;  // no shuffle below
    const float tx = cn.tx, ty = cn.ty;
    const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
    const float w10 = (1.f - tx) * ty, w11 = tx * ty;
    dattn[pt] = w00 * dot[0] + w01 * dot[1] + w10 * dot[2] + w11 * dot[3];
    const float dw0 = a * dot[0], dw1 = a * dot[1], dw2 = a * dot[2],
                dw3 = a * dot[3];
    const float dtx =
        -(1.f - ty) * dw0 + (1.f - ty) * dw1 - ty * dw2 + ty * dw3;
    const float dty =
        -(1.f - tx) * dw0 - tx * dw1 + (1.f - tx) * dw2 + tx * dw3;
    dloc[pt * 2] = dtx * (float)wl;
    dloc[pt * 2 + 1] = dty * (float)hl;
  }
}

// ------------------------------------------------------- 2. scan of counts

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Sum of v over the block, in every thread. `s_warp` holds 32 ints.
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // s_warp may still be read from an earlier use
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += s_warp[w];
  return t;
}

// counts [n_tiles * SCAN_TILE], zero past n_rows; partials [n_tiles].
__global__ void __launch_bounds__(THREADS)
    bwd_tile_sums_kernel(const int* __restrict__ counts,
                         int* __restrict__ partials) {
  __shared__ int s_warp[32];
  const int4 v = reinterpret_cast<const int4*>(
      counts + (long long)blockIdx.x * SCAN_TILE)[threadIdx.x];
  const int t = block_sum(v.x + v.y + v.z + v.w, s_warp);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

// start [n_rows + 1]: the exclusive prefix sum of counts; a row whose count
// is 0 gets a zero d_value row, the block's threads writing its tile's
// rows side by side (16 bytes a thread with VEC, else one element).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    bwd_scan_kernel(const int* __restrict__ counts,
                    const int* __restrict__ partials, int n_rows,
                    int* __restrict__ start, T* __restrict__ dvalue, int D) {
  __shared__ int s_warp[32];
  __shared__ int s_count[SCAN_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the tile's offset: the sums of the tiles before it
  int off = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += blockDim.x)
    off += partials[j];
  off = block_sum(off, s_warp);
  const long long row0 = (long long)blockIdx.x * SCAN_TILE;
  const long long base = row0 + threadIdx.x * SCAN_ITEMS;
  const int4 v4 = reinterpret_cast<const int4*>(counts + base)[0];
  const int v[SCAN_ITEMS] = {v4.x, v4.y, v4.z, v4.w};
  reinterpret_cast<int4*>(s_count)[threadIdx.x] = v4;
  const int total = v[0] + v[1] + v[2] + v[3];
  const int incl = warp_inclusive_scan(total, lane);
  __syncthreads();  // s_warp was read by block_sum
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = off;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  int ex = before + incl - total;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const long long r = base + j;
    if (r < n_rows) {
      start[r] = ex;
      if (r == n_rows - 1) start[n_rows] = ex + v[j];
    }
    ex += v[j];
  }
  const int rows = (int)min((long long)SCAN_TILE, n_rows - row0);
  T* tile = dvalue + row0 * D;
  if constexpr (VEC) {
    constexpr int N = Vec<T>::N;
    const int units = D / N;  // 16-byte units a row
    for (int u = threadIdx.x; u < rows * units; u += THREADS)
      if (s_count[u / units] == 0)
        *reinterpret_cast<uint4*>(tile + (long long)u * N) =
            make_uint4(0, 0, 0, 0);
  } else {
    for (int e = threadIdx.x; e < rows * D; e += THREADS)
      if (s_count[e / D] == 0) tile[e] = from_f32<T>(0.f);
  }
}

// -------------------------------------------------------------- 3. place

// placed [total] int4 (slot c, row, aw as bits, 0), each row's list at
// start[row], in the order the cursor's atomics hand out places.
__global__ void __launch_bounds__(THREADS)
    bwd_place_kernel(const int* __restrict__ key,
                     const float* __restrict__ aw,
                     const int* __restrict__ start, int* __restrict__ cursor,
                     int4* __restrict__ placed, long long n_slots) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_slots) return;
  const int r = key[c];
  if (r >= 0)
    placed[start[r] + atomicAdd(cursor + r, 1)] =
        make_int4((int)c, r, __float_as_int(aw[c]), 0);
}

// --------------------------------------------------------------- 4. sort

#define SORT_TILE 512    // list places a sort block takes
#define SORT_PER (SORT_TILE / THREADS)  // places a thread takes
#define SHORT_ROW 32     // rows of at most this many records are ranked by
                         // comparisons, longer ones by a bit set
#define LONG_PER 4       // a long row's records a thread takes a trip
#define MAX_ROW_POINTS 4096  // Q*P: the bits of a long row's set
#define ROW_WORDS (MAX_ROW_POINTS / 32)
// the long rows whose lists can start in one tile
#define LONG_ROWS ((SORT_TILE - 1) / (SHORT_ROW + 1) + 1)

// u = q*P + p of slot c = (((b*Q + q)*H + h)*L*P + l*P + p)*4 + corner:
// distinct among a row's records, and ordered as their slots.
__device__ __forceinline__ int point_of(int c, int Q, int H, int P, int LP) {
  const int pt = c >> 2;
  const int warp = pt / LP;
  return (warp / H) % Q * P + (pt - warp * LP) % P;
}

// placed [n_slots] records, the first total of them each row's list at
// start[row] in any order; rec the same records with each list in
// ascending slot order. Block t takes the places [t, t + 1) * SORT_TILE: a
// record of a short row is ranked by whichever block holds it, against the
// slots of the places within SHORT_ROW of the tile, staged in shared
// memory; a long row by the block where its list starts, all of it.
__global__ void __launch_bounds__(THREADS)
    bwd_sort_kernel(const int4* __restrict__ placed,
                    const int* __restrict__ start, int n_rows, int n_slots,
                    int Q, int H, int P, int LP, int4* __restrict__ rec) {
  static_assert(SORT_PER * THREADS == SORT_TILE, "whole places a thread");
  static_assert(LONG_ROWS <= 64, "the row offsets' scan holds two a lane");
  static_assert(ROW_WORDS == 128, "a row's set is four words a lane");
  __shared__ uint4 s_bits[LONG_ROWS][ROW_WORDS / 4];
  __shared__ unsigned short s_before[LONG_ROWS][ROW_WORDS];  // bits before
  __shared__ int s_first[LONG_ROWS], s_n[LONG_ROWS], s_off[LONG_ROWS + 1];
  __shared__ int s_n_long;
  // the slots of places [tile - SHORT_ROW, tile + SORT_TILE + SHORT_ROW)
  __shared__ int s_slot[SORT_TILE + 2 * SHORT_ROW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * SORT_TILE;
  // the total, the thread's records and the tile's edges, all in flight
  const int total = start[n_rows];
  int4 r[SORT_PER];
#pragma unroll
  for (int k = 0; k < SORT_PER; ++k) {
    const int i = tile + threadIdx.x + k * THREADS;
    r[k] = i < n_slots ? placed[i] : make_int4(0, -1, 0, 0);
    s_slot[SHORT_ROW + threadIdx.x + k * THREADS] = r[k].x;
  }
  if (threadIdx.x < 2 * SHORT_ROW) {
    const int j = threadIdx.x < SHORT_ROW ? threadIdx.x
                                          : SORT_TILE + threadIdx.x;
    const int i = tile - SHORT_ROW + j;
    s_slot[j] = i >= 0 && i < n_slots ? placed[i].x : 0;
  }
  if (tile >= total) return;  // the same in the whole block
  if (threadIdx.x == 0) s_n_long = 0;
  int a[SORT_PER], n[SORT_PER], rank[SORT_PER], most = 0;
#pragma unroll
  for (int k = 0; k < SORT_PER; ++k) {
    if (tile + (int)threadIdx.x + k * THREADS >= total) r[k].y = -1;
    a[k] = r[k].y >= 0 ? start[r[k].y] : 0;
    n[k] = r[k].y >= 0 ? start[r[k].y + 1] - a[k] : 0;
    rank[k] = 0;
    if (n[k] <= SHORT_ROW) most = max(most, n[k]);
  }
  __syncthreads();  // s_slot and s_n_long are set
  // a short row's record: its rank is the number of smaller slots in its
  // row, which lies within SHORT_ROW places of the record
  for (int j = 0; j < most; ++j)
#pragma unroll
    for (int k = 0; k < SORT_PER; ++k)
      if (j < n[k] && n[k] <= SHORT_ROW)
        rank[k] += s_slot[a[k] - tile + SHORT_ROW + j] < r[k].x;
  // long rows go to the block's list, in any order: each is sorted alone
#pragma unroll
  for (int k = 0; k < SORT_PER; ++k) {
    if (n[k] <= SHORT_ROW) {
      if (r[k].y >= 0) rec[a[k] + rank[k]] = r[k];
    } else if (tile + (int)threadIdx.x + k * THREADS == a[k]) {
      const int s = atomicAdd(&s_n_long, 1);
      s_first[s] = a[k];
      s_n[s] = n[k];
    }
  }
  __syncthreads();
  const int n_long = s_n_long;
  if (n_long == 0) return;
  for (int w = threadIdx.x; w < n_long * (ROW_WORDS / 4); w += THREADS)
    s_bits[w / (ROW_WORDS / 4)][w % (ROW_WORDS / 4)] = make_uint4(0, 0, 0, 0);
  if (warp == 0) {  // the long rows' records laid end to end
    const int n0 = 2 * lane < n_long ? s_n[2 * lane] : 0;
    const int n1 = 2 * lane + 1 < n_long ? s_n[2 * lane + 1] : 0;
    const int incl = warp_inclusive_scan(n0 + n1, lane);
    if (2 * lane < n_long) s_off[2 * lane + 1] = incl - n1;
    if (2 * lane + 1 < n_long) s_off[2 * lane + 2] = incl;
    if (lane == 0) s_off[0] = 0;
  }
  __syncthreads();
  const int n_flat = s_off[n_long];
  unsigned* bits = &s_bits[0][0].x;  // row s's words at s * ROW_WORDS
  // the place of flat record f, and its row in the list; s only grows
  // along a thread's records
  auto locate = [&](int f, int& s) {
    while (f >= s_off[s + 1]) ++s;
    return s_first[s] + f - s_off[s];
  };
  // each long row's points as bits of its set, LONG_PER records a trip
  for (int f0 = threadIdx.x, s = 0; f0 < n_flat;
       f0 += LONG_PER * THREADS) {
    int at[LONG_PER], row[LONG_PER], c[LONG_PER];
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k) {
      const int f = f0 + k * THREADS;
      at[k] = f < n_flat ? locate(f, s) : -1;
      row[k] = s;
    }
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k)
      c[k] = at[k] >= 0 ? placed[at[k]].x : 0;
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k) {
      if (at[k] < 0) continue;
      const int u = point_of(c[k], Q, H, P, LP);
      atomicOr(bits + row[k] * ROW_WORDS + (u >> 5), 1u << (u & 31));
    }
  }
  __syncthreads();
  // the bits before each word of a row's set: a warp a row, four words a
  // lane
  for (int s = warp; s < n_long; s += THREADS / 32) {
    const uint4 w = s_bits[s][lane];
    const int c0 = __popc(w.x), c1 = __popc(w.y), c2 = __popc(w.z);
    const int sum = c0 + c1 + c2 + __popc(w.w);
    const int before = warp_inclusive_scan(sum, lane) - sum;
    unsigned short* out = &s_before[s][lane * 4];
    out[0] = (unsigned short)before;
    out[1] = (unsigned short)(before + c0);
    out[2] = (unsigned short)(before + c0 + c1);
    out[3] = (unsigned short)(before + c0 + c1 + c2);
  }
  __syncthreads();
  // a record's rank: the bits of its row's set below its own
  for (int f0 = threadIdx.x, s = 0; f0 < n_flat;
       f0 += LONG_PER * THREADS) {
    int at[LONG_PER], row[LONG_PER];
    int4 q[LONG_PER];
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k) {
      const int f = f0 + k * THREADS;
      at[k] = f < n_flat ? locate(f, s) : -1;
      row[k] = s;
    }
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k)
      if (at[k] >= 0) q[k] = placed[at[k]];
#pragma unroll
    for (int k = 0; k < LONG_PER; ++k) {
      if (at[k] < 0) continue;
      const int u = point_of(q[k].x, Q, H, P, LP);
      const int w = u >> 5;
      rec[s_first[row[k]] + s_before[row[k]][w] +
          __popc(bits[row[k] * ROW_WORDS + w] & ((1u << (u & 31)) - 1u))] =
          q[k];
    }
  }
}

// ------------------------------------------------------------- 5. reduce

// Pieces of a sub-group's f32 partial row, to p (shared memory).
template <int K, int N>
__device__ __forceinline__ void put_f32(float* p, float (&acc)[K][N],
                                        int sl, int G, int D) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = piece_at<N>(sl, k, G);
    if (e < D)
#pragma unroll
      for (int n = 0; n < N; ++n) p[e + n] = acc[k][n];
  }
}

// acc += the pieces at p.
template <int K, int N>
__device__ __forceinline__ void add_f32(float (&acc)[K][N], const float* p,
                                        int sl, int G, int D) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = piece_at<N>(sl, k, G);
    if (e < D)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[k][n] += p[e + n];
  }
}

// A sub-group's row of acc, in the output dtype.
template <typename T, bool VEC, int K>
__device__ __forceinline__ void put_row(T* p,
                                        float (&acc)[K][Piece<T, VEC>::N],
                                        int sl, int G, int D) {
  constexpr int N = Piece<T, VEC>::N;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = piece_at<N>(sl, k, G);
    if (e < D) Piece<T, VEC>::store(p + e, acc[k]);
  }
}

// SG * D <= 256 * N * K floats: the pieces a block's sub-groups keep
#define SMEM_ROWS 2048

// 6. fixup, for reduce block blk, by a sub-group of G lanes: where the
// block holds the part of a row that starts in it and runs past it, add
// the heads of the blocks the row runs into, in block order, and write the
// row. A row spans few blocks (a block sums THREADS / G * CHUNK slots:
// 1,024 for a bf16 row at D=32).
template <typename T, bool VEC, int K>
__device__ __forceinline__ void fixup_block(long long blk,
                                            const int* __restrict__ start,
                                            const float* carry,
                                            const int* carry_row, int D,
                                            int G, int sl,
                                            T* __restrict__ dvalue) {
  constexpr int N = Piece<T, VEC>::N;
  const int r = carry_row[blk];
  if (r < 0) return;
  const long long slots = (long long)(THREADS / G) * CHUNK;
  const long long b_end = (start[r + 1] - 1) / slots;
  float acc[K][N];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int e = piece_at<N>(sl, kk, G);
#pragma unroll
    for (int n = 0; n < N; ++n)
      acc[kk][n] = e < D ? carry[(blk * 2 + 1) * D + e + n] : 0.f;
  }
  for (long long b2 = blk + 1; b2 <= b_end; ++b2)
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const int e = piece_at<N>(sl, kk, G);
      if (e < D)
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc[kk][n] += carry[b2 * 2 * D + e + n];
    }
  put_row<T, VEC, K>(dvalue + (long long)r * D, acc, sl, G, D);
}

// rec [total] (slot, row, aw), sorted by row and by slot within a row.
// Block j-th sub-group (G
// lanes) sums chunk
// blockIdx.x * SG + j of CHUNK slots, SG = THREADS / G. A row that lies in
// one chunk is written at once. The pieces of rows that cross chunk edges
// meet in shared memory: the sub-group whose chunk holds a row's start
// sums the pieces of the chunks it runs into; a row that runs past the
// block's last chunk goes to the block's carry instead, and so does the
// block's head, the part of a row that runs into the block from before.
// carry [n_blocks, 2, D] f32: the head, then the part of the row that
// starts in the block and runs past it; carry_row [n_blocks]: that row,
// or -1.
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(THREADS)
    bwd_reduce_kernel(const T* __restrict__ grad,
                      const int4* __restrict__ rec,
                      const int* __restrict__ start, int n_rows,
                      long long n_slots, int LP4,
                      int D, int G, T* __restrict__ dvalue,
                      float* __restrict__ carry,
                      int* __restrict__ carry_row) {
  using R = Piece<T, VEC>;
  constexpr int N = R::N;
  __shared__ float s_first[SMEM_ROWS], s_last[SMEM_ROWS];
  // per sub-group: the row of its first piece if that piece continues a
  // row from the chunk before (-1 else), whether the chunk holds nothing
  // else and the row runs on past it, and the row its last piece starts
  // and carries past the chunk (-1 else)
  __shared__ int s_first_row[THREADS], s_first_on[THREADS],
      s_last_row[THREADS];
  const int SG = THREADS / G;
  const int j = threadIdx.x / G, sl = threadIdx.x & (G - 1);
  const long long k = (long long)blockIdx.x * SG + j;
  const long long s_begin = k * CHUNK;
  if (threadIdx.x == 0) carry_row[blockIdx.x] = -1;
  // the chunk's records and its neighbours' rows, read while the total
  // (the first place past the lists) is on its way; those past it are
  // dropped below
  int c[CHUNK], r[CHUNK];
  float a[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    const int4 q = s_begin + u < n_slots ? rec[s_begin + u]
                                         : make_int4(-1, -1, 0, 0);
    c[u] = q.x;
    r[u] = q.y;
    a[u] = __int_as_float(q.z);
  }
  const int prev_rec = s_begin > 0 && s_begin <= n_slots
                           ? rec[s_begin - 1].y : -1;
  const int next_rec = s_begin + CHUNK < n_slots ? rec[s_begin + CHUNK].y
                                                 : -1;
  const int total = start[n_rows];

  int first_row = -1, first_on = 0, last_row = -1;
  float acc[K][N];
  if (s_begin < total) {
    const int s_end = (int)min(s_begin + CHUNK, (long long)total);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      if (s_begin + u >= s_end) c[u] = -1;
    const int prev_row = s_begin > 0 ? prev_rec : -1;
    const int next_row = s_end < total ? next_rec : -1;
    int cur = -1;
    bool first = true;
    auto flush = [&](bool last) {
      const bool in = first && cur == prev_row;
      const bool out = last && cur == next_row;
      if (in) {
        put_f32<K, N>(s_first + j * D, acc, sl, G, D);
        first_row = cur;
        first_on = out;
      } else if (out) {
        put_f32<K, N>(s_last + j * D, acc, sl, G, D);
        last_row = cur;
      } else {
        put_row<T, VEC, K>(dvalue + (long long)cur * D, acc, sl, G, D);
      }
      first = false;
    };
#pragma unroll
    for (int u0 = 0; u0 < CHUNK; u0 += 4) {
      if (c[u0] < 0) break;  // past the chunk's end: the same in every lane
      // four g rows in flight
      float gv[4][K][N];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cu = c[u0 + u];
        const T* gp = grad + (long long)(cu >= 0 ? cu / LP4 : 0) * D;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const int e = piece_at<N>(sl, kk, G);
          if (cu >= 0 && e < D) {
            R::load(gp + e, gv[u][kk]);
          } else {
#pragma unroll
            for (int n = 0; n < N; ++n) gv[u][kk][n] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c[u0 + u] < 0) break;
        if (r[u0 + u] != cur) {
          if (cur >= 0) flush(false);
          cur = r[u0 + u];
#pragma unroll
          for (int kk = 0; kk < K; ++kk)
#pragma unroll
            for (int n = 0; n < N; ++n) acc[kk][n] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[kk][n] += a[u0 + u] * gv[u][kk][n];
      }
    }
    flush(true);
  }
  if (sl == 0) {
    s_first_row[j] = first_row;
    s_first_on[j] = first_on;
    s_last_row[j] = last_row;
  }
  __syncthreads();
  // a row that starts in this chunk and runs on: sum the next chunks'
  // first pieces while it lasts
  if (last_row >= 0) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[kk][n] = 0.f;
    add_f32<K, N>(acc, s_last + j * D, sl, G, D);
    bool ended = false;
    for (int j2 = j + 1; j2 < SG && !ended; ++j2) {
      add_f32<K, N>(acc, s_first + j2 * D, sl, G, D);
      ended = !s_first_on[j2];
    }
    if (ended) {
      put_row<T, VEC, K>(dvalue + (long long)last_row * D, acc, sl, G, D);
    } else {  // past the block's last chunk
      float* c_out = carry + ((long long)blockIdx.x * 2 + 1) * D;
      put_f32<K, N>(c_out, acc, sl, G, D);
      if (sl == 0) carry_row[blockIdx.x] = last_row;
    }
  }
  // the block's head: a row that runs in from before the block
  if (j == 0 && first_row >= 0) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[kk][n] = 0.f;
    add_f32<K, N>(acc, s_first, sl, G, D);
    for (int j2 = 0; s_first_on[j2] && j2 + 1 < SG; ++j2)
      add_f32<K, N>(acc, s_first + (j2 + 1) * D, sl, G, D);
    put_f32<K, N>(carry + (long long)blockIdx.x * 2 * D, acc, sl, G, D);
  }
}

template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(THREADS)
    bwd_fixup_kernel(const int* __restrict__ start,
                     const float* __restrict__ carry,
                     const int* __restrict__ carry_row, int D, int G,
                     long long n_blocks, T* __restrict__ dvalue) {
  const long long blk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (blk < n_blocks)
    fixup_block<T, VEC, K>(blk, start, carry, carry_row, D, G,
                           threadIdx.x & (G - 1), dvalue);
}

// ---------------------------------------------------------------- host

static long long align256(long long n) { return (n + 255) / 256 * 256; }

// The workspace for one shape: offsets in bytes of key, aw, placed, rec,
// counts (with the cursors after them), start, partials, carry_row and
// carry, and the total.
#define N_PARTS 9
struct Layout {
  long long off[N_PARTS];
  long long total;
  long long n_slots, n_rows, n_tiles, n_chunks;
};

// Reduce blocks hold at least THREADS / 32 chunks (a row on 32 lanes).
#define MAX_REDUCE_BLOCKS(n_chunks) ((n_chunks) / (THREADS / 32) + 1)

static bool layout(const Dims& d, Layout& ly) {
  if (d.D < 1 || d.D > MAX_ROW_D || d.B < 1 || d.S < 1 || d.Q < 1 ||
      d.H < 1 || d.P < 1 || d.L * d.P > MAX_LP ||
      (long long)d.Q * d.P > MAX_ROW_POINTS)
    return false;
  ly.n_slots = (long long)d.B * d.Q * d.H * d.L * d.P * 4;
  ly.n_rows = (long long)d.B * d.S * d.H;
  // int32 keys, slots and starts
  if (ly.n_slots >= INT_MAX || ly.n_rows >= INT_MAX) return false;
  ly.n_tiles = (ly.n_rows + SCAN_TILE - 1) / SCAN_TILE;
  ly.n_chunks = (ly.n_slots + CHUNK - 1) / CHUNK;
  const long long n_blocks = MAX_REDUCE_BLOCKS(ly.n_chunks);
  const long long sizes[N_PARTS] = {
      ly.n_slots * 4,                      // key
      ly.n_slots * 4,                      // aw
      ly.n_slots * 16,                     // placed
      ly.n_slots * 16,                     // rec
      ly.n_tiles * SCAN_TILE * 4 * 2,      // counts, cursors: whole tiles
      (ly.n_rows + 1) * 4,                 // start
      ly.n_tiles * 4,                      // partials
      n_blocks * 4,                        // carry_row, one a reduce block
      n_blocks * 2 * (long long)d.D * 4};  // carry, two rows a block
  long long at = 0;
  for (int i = 0; i < N_PARTS; ++i) {
    ly.off[i] = at;
    at += align256(sizes[i]);
  }
  ly.total = at;
  return true;
}

// Bytes of workspace `ms_deform_attn_bwd` needs for the shape block, and
// the offsets of key, aw, placed, rec, counts, start, partials, carry_row
// and carry in it (9 values); -1 for a shape it does not take.
extern "C" long long ms_deform_attn_bwd_workspace(const int* dims,
                                                  long long* offsets) {
  Dims d;
  Layout ly;
  if (!read_dims(dims, d) || !layout(d, ly)) return -1;
  for (int i = 0; i < N_PARTS; ++i) offsets[i] = ly.off[i];
  return ly.total;
}

static unsigned blocks_for(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

template <typename T, bool VEC>
static int launch(const void* value, const void* loc, const void* attn,
                  const void* grad, void* dvalue, float* dloc, float* dattn,
                  char* ws, const Layout& ly, const Dims& d,
                  cudaStream_t stream) {
  constexpr int N = Piece<T, VEC>::N, K = row_pieces(VEC);
  const int G = row_lanes(d.D, N, K);
  if (G == 0 || (THREADS / G) * d.D > SMEM_ROWS)
    return (int)cudaErrorInvalidValue;
  int* key = (int*)(ws + ly.off[0]);
  float* aw = (float*)(ws + ly.off[1]);
  int4* placed = (int4*)(ws + ly.off[2]);
  int4* rec = (int4*)(ws + ly.off[3]);
  int* counts = (int*)(ws + ly.off[4]);
  int* cursor = counts + ly.n_tiles * SCAN_TILE;
  int* start = (int*)(ws + ly.off[5]);
  int* partials = (int*)(ws + ly.off[6]);
  int* carry_row = (int*)(ws + ly.off[7]);
  float* carry = (float*)(ws + ly.off[8]);
  cudaError_t err =  // the counts and the cursors
      cudaMemsetAsync(counts, 0, ly.n_tiles * SCAN_TILE * 4 * 2, stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_warps = (long long)d.B * d.Q * d.H;
  bwd_dots_kernel<T, VEC, K>
      <<<blocks_for(n_warps * 32), THREADS, 0, stream>>>(
          (const T*)value, (const float*)loc, (const float*)attn,
          (const T*)grad, dloc, dattn, key, aw, counts, d.S, d.Q, d.H, d.D,
          d.L, d.P, G, n_warps, d.lv);
  bwd_tile_sums_kernel<<<(unsigned)ly.n_tiles, THREADS, 0, stream>>>(
      counts, partials);
  bwd_scan_kernel<T, VEC><<<(unsigned)ly.n_tiles, THREADS, 0, stream>>>(
      counts, partials, (int)ly.n_rows, start, (T*)dvalue, d.D);
  bwd_place_kernel<<<blocks_for(ly.n_slots), THREADS, 0, stream>>>(
      key, aw, start, cursor, placed, ly.n_slots);
  bwd_sort_kernel<<<(unsigned)((ly.n_slots + SORT_TILE - 1) / SORT_TILE),
                    THREADS, 0, stream>>>(placed, start, (int)ly.n_rows,
                                          (int)ly.n_slots, d.Q, d.H, d.P,
                                          d.L * d.P, rec);
  const long long n_blocks = blocks_for(ly.n_chunks * G);
  bwd_reduce_kernel<T, VEC, K><<<(unsigned)n_blocks, THREADS, 0, stream>>>(
      (const T*)grad, rec, start, (int)ly.n_rows, ly.n_slots,
      d.L * d.P * 4, d.D, G, (T*)dvalue, carry, carry_row);
  bwd_fixup_kernel<T, VEC, K><<<blocks_for(n_blocks * G), THREADS, 0,
                                stream>>>(start, carry, carry_row, d.D, G,
                                          n_blocks, (T*)dvalue);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_rows(const void* value, const void* loc, const void* attn,
                       const void* grad, void* dvalue, float* dloc,
                       float* dattn, char* ws, const Layout& ly,
                       const Dims& d, cudaStream_t stream) {
  if (rows_vec16<T>(value, d.D) && rows_vec16<T>(grad, d.D) &&
      rows_vec16<T>(dvalue, d.D))
    return launch<T, true>(value, loc, attn, grad, dvalue, dloc, dattn, ws,
                           ly, d, stream);
  return launch<T, false>(value, loc, attn, grad, dvalue, dloc, dattn, ws, ly,
                          d, stream);
}

// dims: dtype (0 = f32, 1 = bf16, 2 = fp16: value, grad and dvalue), B, S,
// Q, H, D, L, P, then L pairs (h, w). workspace:
// `ms_deform_attn_bwd_workspace` bytes on a 256-byte boundary. D <= 128,
// L*P <= 64, Q*P <= 4096, B*S*H and B*Q*H*L*P*4 below 2^31.
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc,
                                  const void* attn, const void* grad,
                                  void* dvalue, float* dloc, float* dattn,
                                  void* workspace, const int* dims,
                                  void* stream) {
  Dims d;
  Layout ly;
  if (!read_dims(dims, d) || !layout(d, ly) ||
      ((uintptr_t)workspace & 255) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* ws = (char*)workspace;
  switch (d.dtype) {
    case 0:
      return launch_rows<float>(value, loc, attn, grad, dvalue, dloc, dattn,
                                ws, ly, d, st);
    case 1:
      return launch_rows<__nv_bfloat16>(value, loc, attn, grad, dvalue, dloc,
                                        dattn, ws, ly, d, st);
    case 2:
      return launch_rows<__half>(value, loc, attn, grad, dvalue, dloc, dattn,
                                 ws, ly, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
