// K3 masked_cosine_topk: bitmap-masked (Q, n) cosine scores -> per-query
// top-k (sims descending, ties to the lower id; -inf/-1 when fewer than k
// rows pass).
//
// Replaces the Pallas kernel behind src/repro/kernels/masked_cosine_topk.py
// masked_cosine_topk (_kernel). On the TPU the corpus tiles ran in order on
// one core and the output block carried a running top-k from one grid step
// to the next. Blocks on a GPU run in parallel and in no order, so the work
// is split in two passes: pass 1 gives each (query tile, corpus chunk)
// block its own top-k per query, written to scratch; pass 2 merges each
// query's chunk lists in chunk order.
//
// What bounds it on the H100. With a dense mask, operations: 2*Q*n*d
// multiply-adds. fp32 on the CUDA cores peaks at 67 TFLOP/s; the tensor
// cores do TF32 at 495 TFLOP/s, but TF32 keeps 10 mantissa bits and the
// port's numerics are fp32. So the product runs as 3xTF32: each operand
// splits into hi = tf32(x) and lo = tf32(x - hi), and hi*hi + hi*lo + lo*hi
// accumulate in fp32 (mma.sync m16n8k8), which is as accurate as an fp32
// dot product at three times the TF32 work (3 * 2*Q*n*d / 495 TFLOP/s). On
// the search path each call's mask is one atlas cluster per query (a
// fraction of a percent of the rows per query), and then bytes bound it:
// only rows some query of the tile passes need to be read.
//
// Design. A pass-1 block owns 64 queries (kQT) and a chunk of up to 2,048
// rows (the wrapper picks the chunk so that the grid fills every SM with
// two blocks). It ORs its queries' bitmap words over the chunk, per group
// of 16 queries (one MMA m-tile), and compacts the rows to multiply into a
// list in shared memory, so a chunk no query of the tile passes costs one
// bitmap read. Two layouts of that list:
// - union: the rows any of the 64 queries passes, in id order; every
//   query meets every row (a dense mask is a plain tiled product);
// - grouped, when the groups share few rows (the one-cluster masks of the
//   search path): one segment per group of the rows its queries pass, in
//   id order, padded to whole 8-row n-tiles. An n-tile then needs its own
//   group's m-tile only, a quarter of the union layout's products.
// The list is multiplied in 128-row score tiles, 32 floats of depth per
// stage: a ring of three shared-memory stages (rows XOR-swizzled, no
// padding) is filled with 16-byte cp.async copies of the query slice and
// the gathered row slices, each thread's copy sources fixed per tile, so
// stages s+1 and s+2 are in flight while the MMAs of stage s run. Four
// warps each own 32 rows of the tile against all 64 queries (a 64x32
// accumulator in registers), so each operand element split into hi/lo
// feeds several products. The splits are integer round-to-nearest on the
// fp32 bits (cvt.rna.tf32's result, off the slower conversion pipe). Two
// blocks fit on an SM (~107 KB of shared memory each).
//
// Why 64 queries: with the 8-query tile of the first port, a dense mask at
// Q=256 streamed the 861 MB corpus 32 times; at 64 it is 4 times, and the
// grid puts the four query tiles of a chunk next to each other so they
// meet in L2. On the path's one-cluster masks a 64-query tile gathers the
// union of up to 64 clusters (about 64 * 324 rows at paper scale, of which
// each query uses its own ~324): each needed row is still read once per
// tile, so the bytes stay about what the 8-query tile read (more queries
// share each row), and the grouped layout keeps the extra products to
// those of 16 queries per row.
//
// Top-k: each warp's 32 rows of a finished tile go to shared memory in
// turn with failing lanes at -inf; after each, warp w offers queries w,
// w+4, ... those candidates in id order (a query sees only its own
// group's segment when grouped, so its candidates still arrive in id
// order). Each query's list (k <= 32, lane i holding the i-th best) lives
// in shared memory between tiles. A candidate enters only if its score is
// strictly above the current k-th score, and it goes after every entry
// with an equal score: exactly "ties to the lower id", the order the
// Pallas running merge (lax.top_k) produced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQT = 64;            // queries per block
constexpr int kBN = 128;           // gathered rows per score tile
constexpr int kBK = 32;            // depth per pipeline stage
constexpr int kStages = 3;         // shared-memory ring depth
constexpr int kWarps = 4;          // warp w: 64 queries x rows 32w..32w+31
constexpr int kThreads = kWarps * 32;
constexpr int kChunksPerRow = kBK / 4;          // 16-byte copies per row
constexpr int kRowsPerPass = kThreads / kChunksPerRow;
constexpr int kQPasses = kQT / kRowsPerPass;    // vec4 copies per thread:
constexpr int kXPasses = kBN / kRowsPerPass;    // query rows, tile rows
constexpr int kScorePitch = 32 + 8;  // the epilogue stages 32 rows at once
constexpr int kMaxChunkWords = 64;   // chunk <= 2,048 rows
constexpr int kGroup = 16;           // queries per group (one m-tile)
constexpr int kGroups = kQT / kGroup;
constexpr int kMergeWarps = 8;

static_assert(kBK % 8 == 0 && kBK <= 32 && kThreads == 2 * kMaxChunkWords &&
                  kWarps * 32 == kBN && kQT % kRowsPerPass == 0,
              "tile layout");

struct Smem {
  float stage[kStages][(kQT + kBN) * kBK];  // query slice, then tile rows
  float score[kQT][kScorePitch];
  float list_s[kQT][32];
  int list_i[kQT][32];
  int rows[kMaxChunkWords * 32];
  unsigned group_or[kGroups][kMaxChunkWords];
  int scan_sum[kWarps][3];
};

// Staged rows are kBK floats with no padding; the 16-byte chunks of a row
// are XOR-swizzled by the row index so that a fragment load (rows g, g+1,
// ..., g+7 at one column) hits 32 different banks and a 16-byte copy
// stays contiguous.
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int shift = kBK == 32 ? 0 : kBK == 16 ? 1 : 2;
  return r * kBK + (c ^ (((r >> shift) & (kChunksPerRow - 1)) << 2));
}

// Insert (cs, ci) into the warp's sorted list (lanes 0..k-1). The caller
// guarantees cs is finite and above the k-th score, and that ci exceeds the
// id of every listed entry with an equal score.
__device__ __forceinline__ void list_insert(float& ls, int& li, float cs,
                                            int ci, int k, int lane) {
  const unsigned before = __ballot_sync(kFull, lane < k && ls >= cs);
  const int p = __popc(before);
  const float up_s = __shfl_up_sync(kFull, ls, 1);
  const int up_i = __shfl_up_sync(kFull, li, 1);
  if (lane < k) {
    if (lane == p) {
      ls = cs;
      li = ci;
    } else if (lane > p) {
      ls = up_s;
      li = up_i;
    }
  }
}

// Offer one candidate per lane, in lane order (= increasing id order).
__device__ __forceinline__ void offer(float& ls, int& li, bool ok, float cs,
                                      int ci, int k, int lane) {
  float thresh = __shfl_sync(kFull, ls, k - 1);
  unsigned pend = __ballot_sync(kFull, ok && cs > thresh);
  while (pend) {
    const int j = __ffs(pend) - 1;
    pend &= pend - 1;
    const float s = __shfl_sync(kFull, cs, j);
    const int id = __shfl_sync(kFull, ci, j);
    if (s > thresh) {
      list_insert(ls, li, s, id, k, lane);
      thresh = __shfl_sync(kFull, ls, k - 1);
    }
  }
}

// One pipeline stage of a warp's 3xTF32 products: sq is the stage's query
// slice, sx its tile rows; the warp owns tile rows wr..wr+31 (n-tiles ni =
// 0..3). Union layout: all four m-tiles of queries times all four
// n-tiles, into acc[mi][ni] (gn unused). Grouped layout: n-tile ni holds
// rows of group gn[ni] only, so it meets that group's m-tile alone, into
// acc[0][ni] (gn[ni] == kGroups marks padding past the last segment).
template <bool kGrouped>
__device__ __forceinline__ void mma_stage(const float* sq, const float* sx,
                                          float (&acc)[4][4][4], int g,
                                          int t4, int wr, const int* gn) {
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 8) {
    // A fragments: union, one per m-tile; grouped, one per n-tile
    uint32_t a_hi[4][4], a_lo[4][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // union: m-tile i; grouped: the m-tile of n-tile i's group
      const int r = (kGrouped ? min(gn[i], kGroups - 1) : i) * 16 + g;
      ptx::split_tf32(sq[swz(r, ks + t4)], a_hi[i][0], a_lo[i][0]);
      ptx::split_tf32(sq[swz(r + 8, ks + t4)], a_hi[i][1], a_lo[i][1]);
      ptx::split_tf32(sq[swz(r, ks + t4 + 4)], a_hi[i][2], a_lo[i][2]);
      ptx::split_tf32(sq[swz(r + 8, ks + t4 + 4)], a_hi[i][3], a_lo[i][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wr + ni * 8 + g;
      ptx::split_tf32(sx[swz(r, ks + t4)], b_hi[ni][0], b_lo[ni][0]);
      ptx::split_tf32(sx[swz(r, ks + t4 + 4)], b_hi[ni][1], b_lo[ni][1]);
    }
    // 3xTF32, small terms first: lo*hi, hi*lo, hi*hi (lo*lo is below fp32
    // rounding). Each pass runs over all the accumulators, so a product
    // never waits on the one just issued for the same tile.
    if (kGrouped) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ptx::mma_tf32(acc[0][ni], a_lo[ni], b_hi[ni]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ptx::mma_tf32(acc[0][ni], a_hi[ni], b_lo[ni]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        ptx::mma_tf32(acc[0][ni], a_hi[ni], b_hi[ni]);
    } else {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          ptx::mma_tf32(acc[mi][ni], a_lo[mi], b_hi[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          ptx::mma_tf32(acc[mi][ni], a_hi[mi], b_lo[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          ptx::mma_tf32(acc[mi][ni], a_hi[mi], b_hi[ni]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) topk_partial_kernel(
    const float* __restrict__ queries, const float* __restrict__ corpus,
    const unsigned int* __restrict__ bitmap, int Q, int n, int d, int W,
    int k, int chunk_words, int n_chunks, int vec4, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kQT;
  const int chunk = blockIdx.y;
  const int w0 = chunk * chunk_words;
  const int n_words = (n + 31) / 32;

  for (int i = tid; i < kQT * 32; i += kThreads) {
    sm.list_s[i / 32][i % 32] = -INFINITY;
    sm.list_i[i / 32][i % 32] = -1;
  }

  // 1. per 16-query group (one m-tile), the OR of the group's bitmap words
  // over this chunk, bits of rows >= n cleared: thread t takes word t % 64
  // of groups 2h and 2h + 1, h = t / 64
  const int ww = tid % kMaxChunkWords;
  const int w = w0 + ww;
  const int h = tid / kMaxChunkWords;
  unsigned gw[2] = {0u, 0u};
  if (ww < chunk_words && w < n_words) {
    const int rem = n - w * 32;
    const unsigned tail = rem < 32 ? (1u << rem) - 1u : kFull;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qb = q0 + (2 * h + e) * kGroup;
#pragma unroll 4
      for (int qq = 0; qq < kGroup; ++qq)
        if (qb + qq < Q) gw[e] |= __ldg(bitmap + (size_t)(qb + qq) * W + w);
      gw[e] &= tail;
    }
  }
  sm.group_or[2 * h][ww] = gw[0];
  sm.group_or[2 * h + 1][ww] = gw[1];
  __syncthreads();
  // 2. prefix sums over the chunk's words of the popcounts of the union
  // and of this thread's two groups (warps 0-1 hold words 0-31 / 32-63 of
  // groups 0-1, warps 2-3 of groups 2-3)
  unsigned uni = sm.group_or[0][ww] | sm.group_or[1][ww] |
                 sm.group_or[2][ww] | sm.group_or[3][ww];
  int cnt[3] = {__popc(uni), __popc(gw[0]), __popc(gw[1])};
  int incl[3] = {cnt[0], cnt[1], cnt[2]};
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int v = __shfl_up_sync(kFull, incl[e], o);
      if (lane >= o) incl[e] += v;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int e = 0; e < 3; ++e) sm.scan_sum[warp][e] = incl[e];
  }
  __syncthreads();
  const int n_union = sm.scan_sum[0][0] + sm.scan_sum[1][0];
  int rows_of[kGroups];  // rows group gi's queries pass
  int seg[kGroups + 1];  // group gi's segment: slots seg[gi] .. seg[gi+1]-1
  seg[0] = 0;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int hw = gi / 2 * 2;  // the warps holding group gi
    rows_of[gi] = sm.scan_sum[hw][1 + gi % 2] + sm.scan_sum[hw + 1][1 + gi % 2];
    seg[gi + 1] = seg[gi] + (rows_of[gi] + 7) / 8 * 8;
  }
  // The group layout gives each group a segment of the rows any of its
  // queries passes (id order, padded to whole 8-row n-tiles with -1), so
  // an n-tile needs the products of one m-tile, not four. It is taken
  // when the groups share few rows: its slots must fit and come to at most
  // 5/4 of the union's whole tiles (a dense mask repeats each row in every
  // group and keeps the plain union).
  const bool grouped =
      seg[kGroups] <= kMaxChunkWords * 32 &&
      4 * seg[kGroups] <= 5 * ((n_union + kBN - 1) / kBN * kBN);
  const int total = grouped ? seg[kGroups] : n_union;
  if (grouped) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int off = seg[2 * h + e] + incl[1 + e] - cnt[1 + e] +
                (warp % 2 ? sm.scan_sum[warp - 1][1 + e] : 0);
      for (unsigned bits = gw[e]; bits; bits &= bits - 1)
        sm.rows[off++] = w * 32 + __ffs(bits) - 1;
    }
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {  // the segments' padding
      const int pad = seg[gi] + rows_of[gi] + tid;
      if (pad < seg[gi + 1]) sm.rows[pad] = -1;
    }
  } else if (h == 0) {
    int off = incl[0] - cnt[0] + (warp == 1 ? sm.scan_sum[0][0] : 0);
    for (; uni; uni &= uni - 1) sm.rows[off++] = w * 32 + __ffs(uni) - 1;
  }
  __syncthreads();

  // 3. 3xTF32 product over the gathered rows, pipelined over (tile, depth)
  const int n_k = (d + kBK - 1) / kBK;
  const int n_tiles = (total + kBN - 1) / kBN;
  const int n_steps = n_tiles * n_k;

  // With vec4 each thread owns fixed 16-byte copies of every stage: chunk
  // c4 of staged rows r4 + kRowsPerPass * j, in the query slice and in the
  // tile's rows. Their sources are fixed per block (queries) or per tile
  // (rows), so a step only adds the depth offset.
  const int c4 = (tid % kChunksPerRow) * 4;
  const int r4 = tid / kChunksPerRow;
  const float* q_src[kQPasses];
  const float* x_src[kXPasses];
#pragma unroll
  for (int j = 0; j < kQPasses; ++j) {
    const int q = q0 + r4 + kRowsPerPass * j;
    q_src[j] = q < Q ? queries + (size_t)q * d + c4 : nullptr;
  }
  auto set_tile_rows = [&](int lt) {
#pragma unroll
    for (int j = 0; j < kXPasses; ++j) {
      const int rr = lt * kBN + r4 + kRowsPerPass * j;
      const int id = rr < total ? sm.rows[rr] : -1;
      x_src[j] = id >= 0 ? corpus + (size_t)id * d + c4 : nullptr;
    }
  };
  auto load_vec4 = [&](float* buf, int k0) {
    const bool in_d = k0 + c4 < d;
#pragma unroll
    for (int j = 0; j < kQPasses; ++j) {
      const bool ok = in_d && q_src[j] != nullptr;
      ptx::copy16(buf + swz(r4 + kRowsPerPass * j, c4),
                  ok ? q_src[j] + k0 : queries, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kXPasses; ++j) {
      const bool ok = in_d && x_src[j] != nullptr;
      ptx::copy16(buf + swz(kQT + r4 + kRowsPerPass * j, c4),
                  ok ? x_src[j] + k0 : queries, ok ? 16 : 0);
    }
  };
  // d % 4 != 0 or unaligned inputs: 4-byte copies, addresses per element
  auto load_scalar = [&](float* buf, int lt, int k0) {
    for (int i = tid; i < (kQT + kBN) * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const float* src = queries;
      bool ok = k0 + c < d;
      if (r < kQT) {
        ok = ok && q0 + r < Q;
        if (ok) src = queries + (size_t)(q0 + r) * d + k0 + c;
      } else {
        const int rr = lt * kBN + r - kQT;
        ok = ok && rr < total && sm.rows[rr] >= 0;
        if (ok) src = corpus + (size_t)sm.rows[rr] * d + k0 + c;
      }
      ptx::copy4(buf + swz(r, c), src, ok ? 4 : 0);
    }
  };
  // the load cursor runs kStages - 1 steps ahead of the compute
  int l_tile = 0, l_k = 0;
  if (vec4 && n_steps > 0) set_tile_rows(0);
  auto load_next = [&](int step) {
    float* buf = sm.stage[step % kStages];
    if (vec4) {
      load_vec4(buf, l_k * kBK);
    } else {
      load_scalar(buf, l_tile, l_k * kBK);
    }
    if (++l_k == n_k) {
      l_k = 0;
      ++l_tile;
      if (vec4 && l_tile < n_tiles) set_tile_rows(l_tile);
    }
  };

  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread in group
  const int wr = warp * 32;  // this warp's rows within the tile
  float acc[4][4][4];        // [query m-tile][row n-tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_next(s);
    ptx::commit();
  }
  int step = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // grouped: the group of each of this warp's n-tiles (kGroups past the
    // last segment); uniform across the warp
    int gn[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int slot = tile * kBN + wr + ni * 8;
      gn[ni] = slot >= total ? kGroups
                             : (slot >= seg[1]) + (slot >= seg[2]) +
                                   (slot >= seg[3]);
    }
    for (int kk = 0; kk < n_k; ++kk, ++step) {
      ptx::wait_group<kStages - 2>();
      __syncthreads();  // stage `step` visible; stage step-1 free to refill
      if (step + kStages - 1 < n_steps) load_next(step + kStages - 1);
      ptx::commit();
      const float* sq = sm.stage[step % kStages];
      if (grouped) {
        mma_stage<true>(sq, sq + kQT * kBK, acc, g, t4, wr, gn);
      } else {
        mma_stage<false>(sq, sq + kQT * kBK, acc, g, t4, wr, gn);
      }
    }

    // The tile is complete. Each warp's 32 rows go through shared memory
    // in turn, with -inf where the query's own bit is 0, the slot is
    // padding or (grouped) it belongs to another group's segment; after
    // each, a warp per query offers those candidates (in id order) to the
    // query's list. The accumulators restart at zero.
    for (int owner = 0; owner < kWarps; ++owner) {
      if (owner == warp) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int ql = mi * 16 + g + e2 * 8;
              const int rl = ni * 8 + t4 * 2;
              float v[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int rr = tile * kBN + wr + rl + c;
                const int id = rr < total ? sm.rows[rr] : -1;
                // grouped: only the n-tile's own group has a score, in
                // acc[0][ni]
                const float a = grouped ? acc[0][ni][e2 * 2 + c]
                                        : acc[mi][ni][e2 * 2 + c];
                v[c] = -INFINITY;
                if (q0 + ql < Q && id >= 0 && (!grouped || gn[ni] == mi)) {
                  const unsigned word =
                      __ldg(bitmap + (size_t)(q0 + ql) * W + (id >> 5));
                  if ((word >> (id & 31)) & 1u) v[c] = a;
                }
              }
              *reinterpret_cast<float2*>(&sm.score[ql][rl]) =
                  make_float2(v[0], v[1]);
            }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
      __syncthreads();
      const int rr = tile * kBN + owner * 32 + lane;
      const int id = rr < total ? sm.rows[rr] : -1;
      for (int ql = warp; ql < kQT && q0 + ql < Q; ql += kWarps) {
        float ls = sm.list_s[ql][lane];
        int li = sm.list_i[ql][lane];
        const float v = sm.score[ql][lane];
        offer(ls, li, v > -INFINITY, v, id, k, lane);
        sm.list_s[ql][lane] = ls;
        sm.list_i[ql][lane] = li;
      }
      // the next warp's rows overwrite sm.score; the next tile's first
      // write comes after the next step's barrier
      if (owner + 1 < kWarps) __syncthreads();
    }
  }
  for (int ql = warp; ql < kQT && q0 + ql < Q; ql += kWarps) {
    if (lane < k) {
      const size_t o = ((size_t)(q0 + ql) * n_chunks + chunk) * k + lane;
      part_s[o] = sm.list_s[ql][lane];
      part_i[o] = sm.list_i[ql][lane];
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32) topk_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int Q,
    int n_chunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= Q) return;  // warp-uniform
  float ls = -INFINITY;
  int li = -1;
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c's list is sorted (score desc, id asc) and every id in it
    // exceeds every id of chunks < c: offering it in list order keeps the
    // insertion rule's id-order precondition
    const size_t o = ((size_t)q * n_chunks + c) * k + lane;
    const float s = lane < k ? part_s[o] : -INFINITY;
    const int id = lane < k ? part_i[o] : -1;
    offer(ls, li, lane < k && id >= 0, s, id, k, lane);
  }
  if (lane < k) {
    out_s[(size_t)q * k + lane] = ls;
    out_i[(size_t)q * k + lane] = li;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// queries (Q, d) f32; corpus (n, d) f32; bitmap (Q, W) i32 words with
// W >= ceil(n/32); k in [1, 32]; chunk_words in [1, 64] bitmap words per
// pass-1 block and n_chunks = ceil(ceil(n/32) / chunk_words); part_s/part_i
// scratch of Q * n_chunks * k entries; out_s (Q, k) f32, out_i (Q, k) i32.
// vec4 != 0 promises d % 4 == 0 and 16-byte aligned queries and corpus.
// Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int masked_cosine_topk_launch(
    const void* queries, const void* corpus, const void* bitmap, int Q, int n,
    int d, int W, int k, int chunk_words, int n_chunks, int vec4,
    void* part_s, void* part_i, void* out_s, void* out_i, void* stream) {
  if (Q == 0) return 0;
  const int n_words = (n + 31) / 32;
  if (chunk_words < 1 || chunk_words > kMaxChunkWords || k < 1 || k > 32 ||
      n_chunks != (n_words + chunk_words - 1) / chunk_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (e != cudaSuccess) return static_cast<int>(e);
    // query tiles fastest: the tiles of one chunk run side by side
    const dim3 grid((Q + kQT - 1) / kQT, n_chunks);
    topk_partial_kernel<<<grid, kThreads, sizeof(Smem), st>>>(
        static_cast<const float*>(queries), static_cast<const float*>(corpus),
        static_cast<const unsigned int*>(bitmap), Q, n, d, W, k, chunk_words,
        n_chunks, vec4, static_cast<float*>(part_s),
        static_cast<int*>(part_i));
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return static_cast<int>(e2);
  }
  topk_merge_kernel<<<(Q + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
                      0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), Q,
      n_chunks, k, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
