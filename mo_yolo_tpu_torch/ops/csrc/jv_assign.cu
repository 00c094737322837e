// Exact rectangular assignment (Jonker-Volgenant shortest augmenting
// paths) for Hopper (sm_90a), one block a problem.
//
// Replaces no TPU kernel. The JAX package solves the training step's
// matchings on the device with `_jv_single` (`mo_yolo_tpu/ops/matching.py:
// 90-177`): a `lax.scan` over the GT rows around two XLA `lax.while_loop`s
// (a Dijkstra over the query columns, then the augment walk). PyTorch has
// no device counterpart for a loop whose exit depends on the data: written
// as tensor ops it would read its condition on the host every step. Here
// the whole solve is one launch that allocates nothing and reads nothing
// back, so the training step brings no cost matrix to the host. The grid
// runs one problem a block, so a batch of problems (the aux layers of a
// frame, stacked by the caller) runs side by side.
//
// Per problem b, cost [Q, G] (queries x GT columns), mask [G]:
//
// - G <= Q (every training shape): `_jv_single`'s result and step count.
//   Rows are the GT columns in ascending order, a padded one a constant-0
//   row; one Dijkstra a row over the Q query columns; the argmin takes the
//   lowest index among equal values (`jnp.argmin`); the dual updates run
//   in its order, with its arithmetic: `(C[i0] - u[i0]) - v`, each sum
//   rounded on its own (`__fadd_rn`, `__fsub_rn`: no contraction). So the
//   assignment and the step count equal the JAX solver's on every input,
//   ties included.
// - G > Q: the padded rows are dropped. Where the n valid rows still
//   outnumber the Q queries, the transposed problem is solved (the Q
//   queries as rows over the n valid GT columns). So every Dijkstra reaches
//   a free column and min(Q, n) pairs are assigned at the optimum, where
//   the JAX solver stops a Dijkstra at its cap of Q steps and leaves rows
//   unassigned. Which case applies is decided here from the mask, so the
//   caller never reads the valid count on the host.
//
// What bounds it on the card: neither bytes (the cost matrix, 154 KB at
// Q = 600, G = 64, is read about once) nor operations (a step is a few
// flops a column), but latency: a Dijkstra step is a chain of dependent
// block-wide operations (update the columns, reduce the argmin, read the
// next row), each row's steps depend on the last, and one block a problem
// leaves most of an SM's instruction slots idle. The design cuts the number
// of steps walked and the latency of each:
//
// 1. Padded rows decided at once (G <= Q). A padded row's walk, in the
//    JAX solver, visits every column assigned before it that zero reduced
//    costs reach: ~95 % of a training call's steps. Where v <= 0 on every
//    column and no row that walk reaches has a negative reduced cost off
//    its own column (in the walk's own f32 rounding), every delta of the
//    walk is exactly 0: nothing moves but col2row[f0] = r, f0 the lowest
//    free column, and the walk takes |closure| + 1 steps, the closure being
//    the columns below f0 that zero reduced costs reach from the columns
//    with v = 0. Each processed row keeps in shared memory its tight
//    columns (a bit set over the G lowest columns, since f0 < G) and its
//    count of negative reduced costs. Only a walk moves u and v, so before
//    the next padded row after a walk one parallel pass rebuilds them, a
//    warp a row. Warp 0 then grows the closure in rounds (every pending
//    column's row at once, their bit sets OR-reduced over the warp) and
//    keeps it from one padded row to the next, as it only grows while u
//    and v hold. Where the check fails (costs at 1e6 whose reduced costs
//    round below 0) the row is walked: the same kernel's exact branch. So
//    are all rows where the sets do not fit (G > 1,024, or the shared
//    memory).
// 2. A walked step reads shared memory and registers: the valid GT rows of
//    the cost are staged at the start, transposed (n x Q floats, 48 KB at
//    20 x 600), as many as fit (the rest are read as a strided column
//    through L2); each of 512 threads keeps its columns j = t, t + 512,
//    ... (up to four; in shared memory past 2,048 columns) in registers:
//    v, minv, the predecessor and, once in the tree, the row. A step is
//    one block barrier: a thread applies the last step's delta to its
//    columns (minv; v and the u of their rows once they are in the tree)
//    before it updates them with the next row, with selects rather than
//    branches and every cost read first, so that its columns overlap; only
//    the warps' argmin partials (double-buffered) cross the barrier. The
//    argmin is one 64-bit key (the value's order bits, then the index),
//    reduced by `redux.sync`. More threads than columns a warp would need
//    measured faster: 512 against 256 and 128.
// 3. One launch for many problems: the caller stacks the aux layers of a
//    frame, and their blocks run on separate SMs.
//
// Plain C entry points, bound with ctypes; they launch on the caller's
// stream and return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define WARPS (THREADS / 32)
#define FULL 0xffffffffu
#define JV_INF 1e30f  // `_INF` of the JAX solver, as f32
// what one block may take of an SM's shared memory on sm_90 (227 KB)
#define MAX_DYNAMIC_SMEM 232448
// way[j] holds the predecessor column + 1, and this flag once column j is
// in the Dijkstra's tree
#define IN_TREE 0x80000000u
// the tight sets take one 32-bit word a lane of warp 0
#define TIGHT_MAX_G 1024

// Shared memory of one problem: the walk's state (`base`: the warps'
// partials twice and four counters, K = max(Q, G) columns of v, minv, way
// and col2row, R = min(Q, G) rows of u, the G valid indices and, where
// G <= Q, the mask), then where they fit the tight sets (G <= Q: G rows
// of W words, a count a row, the v = 0 words; `_tight_sets_fit` in
// `ops/matching.py` repeats this rule), then the staged cost (the valid GT
// rows' ranks and `stage_rows` rows of Q floats).
struct Plan {
  size_t base, tight, stage;
  int stage_rows;
};

__host__ __device__ inline Plan plan(int Q, int G) {
  const size_t K = Q > G ? Q : G, R = Q < G ? Q : G, W = (G + 31) / 32;
  Plan p;
  p.base = 16 * (size_t)WARPS + 16 + 16 * K + 4 * R + 4 * (size_t)G;
  if (G <= Q) p.base = (p.base + G + 15) / 16 * 16;  // the mask, mode 0
  p.tight = 0;
  if (G <= Q && G <= TIGHT_MAX_G) {
    const size_t t = 4 * (size_t)G * W + 4 * (size_t)G + 4 * W;
    if (p.base + t <= MAX_DYNAMIC_SMEM) p.tight = t;
  }
  p.stage = 0;
  p.stage_rows = 0;
  const size_t used = p.base + p.tight + 4 * (size_t)G;
  if (used < MAX_DYNAMIC_SMEM) {
    size_t rows = (MAX_DYNAMIC_SMEM - used) / (4 * (size_t)Q);
    if (rows > R) rows = R;
    if (rows > 0) {
      p.stage_rows = (int)rows;
      p.stage = 4 * (size_t)G + 4 * rows * Q;
    }
  }
  return p;
}

// The argmin's order as one unsigned key: -0 and +0 as one value (they are
// equal to `jnp.argmin`), then the float order. Packed over the column, a
// smaller key is the smaller value, then the lower index.
__device__ __forceinline__ unsigned long long argmin_key(float x, int j) {
  const unsigned b = __float_as_uint(x == 0.f ? 0.f : x);
  const unsigned k = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)k << 32) | (unsigned)j;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned k = (unsigned)(key >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long p) {
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(p >> 32));
  const unsigned lo =
      __reduce_min_sync(FULL, (unsigned)(p >> 32) == hi ? (unsigned)p : FULL);
  return ((unsigned long long)hi << 32) | lo;
}

// cost [B, Q, G] f32, mask [B, G] bool (one byte), assign [B, G] int32,
// iters [B] int32 or null: contiguous; counts [3] or null, to which each
// problem adds its steps walked, padded rows decided and padded rows
// walked. Grid B, THREADS threads.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    jv_assign_kernel(const float* __restrict__ cost,
                     const uint8_t* __restrict__ mask,
                     int* __restrict__ assign, int* __restrict__ iters,
                     unsigned long long* __restrict__ counts, int Q,
                     int G) {
  constexpr int CR = C > 0 ? C : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan pl = plan(Q, G);
  const int K_cap = Q > G ? Q : G, R_cap = Q < G ? Q : G;
  const int W = (G + 31) >> 5;
  unsigned long long* part =
      reinterpret_cast<unsigned long long*>(smem);      // [2][WARPS]
  int* s_int = reinterpret_cast<int*>(part + 2 * WARPS);  // [4]
  float* v = reinterpret_cast<float*>(s_int + 4);         // [K_cap]
  float* minv = v + K_cap;                                // [K_cap]
  unsigned* way = reinterpret_cast<unsigned*>(minv + K_cap);  // [K_cap]
  int* col2row = reinterpret_cast<int*>(way + K_cap);     // [K_cap]
  float* u = reinterpret_cast<float*>(col2row + K_cap);   // [R_cap]
  int* vidx = reinterpret_cast<int*>(u + R_cap);          // [G] valid columns
  uint8_t* mk = reinterpret_cast<uint8_t*>(vidx + G);     // [G] if G <= Q
  // the tight sets (mode 0): row i's tight columns below G, its count of
  // negative reduced costs off its own column; the columns with v = 0
  unsigned* tight = reinterpret_cast<unsigned*>(smem + pl.base);  // [G][W]
  int* nbad = reinterpret_cast<int*>(tight + (size_t)G * W);      // [G]
  unsigned* vzero = reinterpret_cast<unsigned*>(nbad + G);        // [W]
  int* vrank = reinterpret_cast<int*>(smem + pl.base + pl.tight);  // [G]
  float* stage = reinterpret_cast<float*>(vrank + G);  // [stage_rows][Q]
  int &s_n = s_int[0], &s_next = s_int[1], &s_add = s_int[2],
      &s_dec = s_int[3];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cb = cost + (size_t)b * Q * G;
  const uint8_t* mb = mask + (size_t)b * G;
  int* ab = assign + (size_t)b * G;

  // the valid GT columns in ascending order (and each one's rank, where the
  // cost is staged), compacted by warp 0
  if (warp == 0) {
    int base = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const bool m = g < G && mb[g] != 0;
      const unsigned bal = __ballot_sync(FULL, m);
      const int pos = base + __popc(bal & ((1u << lane) - 1u));
      if (m) vidx[pos] = g;
      if (G <= Q && g < G) mk[g] = m;
      if (pl.stage_rows > 0 && g < G) vrank[g] = m ? pos : -1;
      base += __popc(bal);
    }
    if (lane == 0) s_n = base;
  }
  for (int g = tid; g < G; g += THREADS) ab[g] = -1;
  __syncthreads();
  const int n = s_n;
  // 0: G <= Q, every GT a row (the JAX solver's problem); 1: G > Q, the
  // n <= Q valid GT columns as rows; 2: G > Q, the Q queries as rows over
  // the n > Q valid GT columns
  const int mode = G <= Q ? 0 : (n <= Q ? 1 : 2);
  const int R = mode == 0 ? G : (mode == 1 ? n : Q);
  const int K = mode == 2 ? n : Q;
  // the valid GT rows of rank below `n_staged` (modes 0 and 1) are read
  // from shared memory, the others through L2
  const int n_staged = mode == 2 ? 0 : pl.stage_rows;
  const bool decide = mode == 0 && pl.tight > 0;

  if (n_staged > 0) {  // transposed: stage[rank][j] = C[j][g]
    if ((G & 3) == 0 && (reinterpret_cast<uintptr_t>(cb) & 15) == 0) {
      const float4* c4 = reinterpret_cast<const float4*>(cb);
      const int G4 = G >> 2, n4 = Q * G4;
#pragma unroll 4
      for (int e = tid; e < n4; e += THREADS) {
        const float4 x = __ldg(c4 + e);
        const int j = e / G4, g = (e - j * G4) << 2;
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int s = vrank[g + t];
          if (s >= 0 && s < n_staged) stage[(size_t)s * Q + j] = xs[t];
        }
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < Q * G; e += THREADS) {
        const int j = e / G, g = e - j * G, s = vrank[g];
        if (s >= 0 && s < n_staged) stage[(size_t)s * Q + j] = __ldg(cb + e);
      }
    }
  }
  for (int j = tid; j < K; j += THREADS) {
    v[j] = 0.f;
    col2row[j] = -1;
  }
  for (int i = tid; i < R; i += THREADS) u[i] = 0.f;
  __syncthreads();

  // row i's cost (modes 0 and 1: GT column g of each query) in shared
  // memory where it is staged, else null (read through L2); `zero` for a
  // padded row (mode 0), which is constant 0
  auto row_of = [&](int i, bool& zero) -> const float* {
    const int g = mode == 0 ? i : vidx[i];
    zero = mode == 0 && mk[g] == 0;
    const int s = n_staged > 0 && !zero ? vrank[g] : n_staged;
    return s < n_staged ? stage + (size_t)s * Q : nullptr;
  };

  int it = 0, walked = 0, n_decided = 0, n_walked_padded = 0;
  bool stale = true, v_pos = false;
  unsigned A = 0, D = 0;   // warp 0, word `lane`: closure columns, visited
  int r = 0;
  while (r < R) {
    if (decide && mk[r] == 0) {
      if (stale) {
        // bring the tight sets of the rows so far up to date (only a walk
        // moves u and v): a warp a row, anew over every column
        for (int i = warp; i < r; i += WARPS) {
          const float ui = u[i];
          bool zrow;
          const float* srow = row_of(i, zrow);
          int bad = 0;
#pragma unroll 4
          for (int jb = 0; jb < K; jb += 32) {
            const int j = jb + lane;
            float rc = 1.f;
            if (j < K) {
              const float c = zrow   ? 0.f
                              : srow ? srow[j]
                                     : __ldg(cb + (size_t)j * G + i);
              rc = __fsub_rn(__fsub_rn(c, ui), v[j]);
              bad += !(rc >= 0.f) && col2row[j] != i;
            }
            if (jb < G) {
              const unsigned bits = __ballot_sync(FULL, j < G && rc == 0.f);
              if (lane == 0) tight[(size_t)i * W + (jb >> 5)] = bits;
            }
          }
          bad = (int)__reduce_add_sync(FULL, (unsigned)bad);
          if (lane == 0) nbad[i] = bad;
        }
        for (int w = warp; w < W; w += WARPS) {
          const int j = w * 32 + lane;
          const unsigned bits = __ballot_sync(FULL, j < G && v[j] == 0.f);
          if (lane == 0) vzero[w] = bits;
        }
        bool pos = false;
        for (int j = tid; j < K; j += THREADS) pos |= !(v[j] <= 0.f);
        v_pos = __syncthreads_or(pos);
        stale = false;
        A = lane < W ? vzero[lane] : 0u;
        D = 0u;
      }
      if (warp == 0) {
        int rr = r, add = 0, dec = 0, f0 = 0;
        while (!v_pos && rr < R && mk[rr] == 0) {
          // the lowest free column: at or above the last one, at or below rr
          for (int jb = f0 & ~31;; jb += 32) {
            const int j = jb + lane;
            const unsigned fb = __ballot_sync(FULL, j < K && col2row[j] < 0);
            if (fb) {
              f0 = jb + __ffs(fb) - 1;
              break;
            }
          }
          if (v[f0] != 0.f) break;
          const int lo = lane * 32;
          const unsigned below = f0 >= lo + 32 ? FULL
                                 : f0 <= lo    ? 0u
                                               : (1u << (f0 - lo)) - 1u;
          // grow the closure a round at a time: every pending column's row
          // at once, a lane each (their list in `minv`, scratch between
          // walks), their tight words OR-reduced over the warp
          int* list = reinterpret_cast<int*>(minv);
          bool fail = false;
          for (;;) {
            const unsigned pend = A & below & ~D;
            if (__ballot_sync(FULL, pend != 0u) == 0u) break;
            const int cnt = __popc(pend);
            int pre = cnt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(FULL, pre, o);
              if (lane >= o) pre += y;
            }
            const int total = __shfl_sync(FULL, pre, 31);
            int at = pre - cnt;
            for (unsigned bb = pend; bb; bb &= bb - 1u)
              list[at++] = lane * 32 + __ffs(bb) - 1;
            D |= pend;
            __syncwarp();
            for (int t0 = 0; t0 < total && !fail; t0 += 32) {
              const int i = t0 + lane < total ? col2row[list[t0 + lane]] : -1;
              fail = __any_sync(FULL, i >= 0 && nbad[i] != 0);
              for (int w = 0; w < W && !fail; ++w) {
                const unsigned x = __reduce_or_sync(
                    FULL, i >= 0 ? tight[(size_t)i * W + w] : 0u);
                if (lane == w) A |= x;
              }
            }
            __syncwarp();
            if (fail) break;
          }
          if (fail) break;
          add += (int)__reduce_add_sync(FULL, __popc(D)) + 1;
          ++dec;
          // row rr, decided: u = 0, so its tight columns are those with
          // v = 0 and none of its reduced costs is negative
          // (so column f0 joins the closure of the rows after it as seen:
          // its row adds nothing to A, which holds vzero)
          if (lane < W) tight[(size_t)rr * W + lane] = vzero[lane];
          if (lane == 0) {
            nbad[rr] = 0;
            col2row[f0] = rr;
          }
          if (lane == f0 >> 5) D |= 1u << (f0 & 31);
          __syncwarp();
          ++rr;
        }
        if (lane == 0) {
          s_next = rr;
          s_add = add;
          s_dec = dec;
        }
      }
      __syncthreads();
      r = s_next;
      it += s_add;
      n_decided += s_dec;
      if (r >= R) break;
    }

    // walk row r: the Dijkstra, one barrier a step. Thread t owns the
    // columns j = t + c * THREADS: their v, minv, predecessor (+1, with
    // the IN_TREE flag) and, once in the tree, row live in registers where
    // C > 0, in shared memory where C == 0
    float v_r[CR], mv_r[CR];
    unsigned w_r[CR];
    int row_r[CR];
    if constexpr (C > 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = tid + c * THREADS;
        v_r[c] = j < K ? v[j] : 0.f;
        mv_r[c] = JV_INF;
        w_r[c] = 0u;
        row_r[c] = -1;
      }
    } else {
      for (int j = tid; j < K; j += THREADS) {
        minv[j] = JV_INF;
        way[j] = 0u;
      }
    }
    if (mode == 0 && mk[r] == 0) ++n_walked_padded;
    int j0 = -1, i0 = r, k = 0, j_last = -1;
    float d_last = 0.f;
    bool done = false;
    // one column of a step: the last step's delta on it (u on its row and
    // v once in the tree, minv before; at k = 0 the delta is +0 and no
    // column is in the tree), then row i0's reduced cost. Selects, not
    // branches, so that a thread's columns overlap; a column in the tree
    // still reads its cost (a valid address) and ignores it.
    auto column = [&](int j, float& vj, float& mvj, unsigned& wj, int& rowj,
                      float c, float ui0, unsigned long long& best) {
      const bool in_tree = (wj & IN_TREE) != 0u;
      const bool joins = !in_tree && j == j_last;
      if (in_tree) u[rowj] = __fadd_rn(u[rowj], d_last);
      if (joins) rowj = col2row[j];
      vj = in_tree ? __fsub_rn(vj, d_last) : vj;
      mvj = in_tree ? mvj : __fsub_rn(mvj, d_last);
      wj = joins ? wj | IN_TREE : wj;
      const bool open = !in_tree && !joins;
      const float cur = __fsub_rn(__fsub_rn(c, ui0), vj);
      const bool upd = open && cur < mvj;
      mvj = upd ? cur : mvj;
      wj = upd ? (unsigned)(j0 + 1) : wj;
      const unsigned long long key = argmin_key(open ? mvj : JV_INF, j);
      best = key < best ? key : best;
    };
    auto scan = [&](float ui0, auto cost_at) {
      unsigned long long best = ~0ull;
      if constexpr (C > 0) {
        float cst[C];  // every cost read first, so that the reads overlap
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = tid + c * THREADS;
          cst[c] = j < K ? cost_at(j) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = tid + c * THREADS;
          if (j < K)
            column(j, v_r[c], mv_r[c], w_r[c], row_r[c], cst[c], ui0, best);
        }
      } else {
        for (int j = tid; j < K; j += THREADS) {
          float vj = v[j], mvj = minv[j];
          unsigned wj = way[j];
          int rowj = (wj & IN_TREE) != 0u ? col2row[j] : -1;
          column(j, vj, mvj, wj, rowj, cost_at(j), ui0, best);
          v[j] = vj;
          minv[j] = mvj;
          way[j] = wj;
        }
      }
      return best;
    };
    while (k < K) {
      // row i0 of the problem's cost: C[i0][j] = column g of query j
      // (modes 0 and 1: staged, constant 0 or strided), or row i0 at
      // vidx[j] (mode 2)
      const float ui0 = u[i0];
      unsigned long long best;
      if (mode == 2) {
        const float* row = cb + (size_t)i0 * G;
        best = scan(ui0, [&](int j) { return __ldg(row + vidx[j]); });
      } else {
        bool zrow;
        const float* srow = row_of(i0, zrow);
        const float* col = cb + (mode == 0 ? i0 : vidx[i0]);
        if (zrow)
          best = scan(ui0, [](int) { return 0.f; });
        else if (srow != nullptr)
          best = scan(ui0, [&](int j) { return srow[j]; });
        else
          best = scan(ui0, [&](int j) { return __ldg(col + (size_t)j * G); });
      }
      if (tid == 0) u[r] = __fadd_rn(u[r], d_last);
      best = warp_min(best);
      unsigned long long* pk = part + (k & 1) * WARPS;
      if (lane == 0) pk[warp] = best;
      __syncthreads();
      const unsigned long long m = warp_min(lane < WARPS ? pk[lane] : ~0ull);
      d_last = key_value(m);
      j_last = (int)(unsigned)m;
      j0 = j_last;
      ++k;
      const int i_next = col2row[j_last];
      if (i_next < 0) {
        done = true;
        break;
      }
      i0 = i_next;
    }
    // the last step's duals (u on the tree's rows, v on its columns)
    auto finish = [&](float& vj, unsigned wj, int rowj) {
      if ((wj & IN_TREE) != 0u) {
        vj = __fsub_rn(vj, d_last);
        u[rowj] = __fadd_rn(u[rowj], d_last);
      }
    };
    if constexpr (C > 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = tid + c * THREADS;
        if (j < K) {
          finish(v_r[c], w_r[c], row_r[c]);
          v[j] = v_r[c];
          way[j] = w_r[c];
        }
      }
    } else {
      for (int j = tid; j < K; j += THREADS) {
        const unsigned wj = way[j];
        if ((wj & IN_TREE) != 0u) finish(v[j], wj, col2row[j]);
      }
    }
    if (tid == 0) u[r] = __fadd_rn(u[r], d_last);
    it += k;
    walked += k;
    __syncthreads();
    // augment along the predecessor columns back to row r (none where the
    // step cap stopped the search: it cannot when rows <= columns)
    if (done && tid == 0) {
      for (int j = j0; j >= 0;) {
        const int jp = (int)(way[j] & ~IN_TREE) - 1;
        col2row[j] = jp < 0 ? r : col2row[jp];
        j = jp;
      }
    }
    __syncthreads();
    stale = true;
    ++r;
  }

  for (int j = tid; j < K; j += THREADS) {
    const int i = col2row[j];
    if (mode == 2) {
      ab[vidx[j]] = i;
    } else if (i >= 0) {
      const int g = mode == 0 ? i : vidx[i];
      if (mb[g] != 0) ab[g] = j;
    }
  }
  if (tid == 0) {
    if (iters != nullptr) iters[b] = it;
    if (counts != nullptr) {
      atomicAdd(counts, (unsigned long long)walked);
      atomicAdd(counts + 1, (unsigned long long)n_decided);
      atomicAdd(counts + 2, (unsigned long long)n_walked_padded);
    }
  }
}

// The shared memory one problem's block takes, -1 where the walk's state
// does not fit in a block's 227 KB; the wrapper checks it before it
// launches.
extern "C" long long jv_assign_smem_bytes(int Q, int G) {
  if (Q < 1 || G < 1) return -1;
  const Plan p = plan(Q, G);
  return p.base > MAX_DYNAMIC_SMEM ? -1
                                   : (long long)(p.base + p.tight + p.stage);
}

// cost [B, Q, G] f32, mask [B, G] bool, assign [B, G] int32 and iters [B]
// int32 (or null): contiguous; counts [3] 64-bit (or null): the running
// counts each problem adds to. All on the device of the stream.
extern "C" int jv_assign(const void* cost, const void* mask, void* assign,
                         void* iters, void* counts, int B, int Q, int G,
                         void* stream) {
  const long long smem = jv_assign_smem_bytes(Q, G);
  if (B < 1 || smem < 0) return (int)cudaErrorInvalidValue;
  // a thread's columns in registers where they are at most 4
  const int K = Q > G ? Q : G;
  void (*kernel)(const float*, const uint8_t*, int*, int*,
                 unsigned long long*, int, int) =
      K <= THREADS       ? jv_assign_kernel<1>
      : K <= 2 * THREADS ? jv_assign_kernel<2>
      : K <= 3 * THREADS ? jv_assign_kernel<3>
      : K <= 4 * THREADS ? jv_assign_kernel<4>
                         : jv_assign_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const uint8_t*)mask, (int*)assign, (int*)iters,
      (unsigned long long*)counts, Q, G);
  return (int)cudaGetLastError();
}
