// K1 filter_eval_batch: predicate clause tables -> packed pass bitmaps,
// and K4 filter_eval, its single-query conjunctive form.
//
// Replaces the Pallas kernels behind src/repro/kernels/filter_eval.py
// filter_eval_batch: _batch_kernel (conjunctive (Q, C) tables),
// _dnf_batch_kernel (disjunctive (Q, D, C) tables) and
// _dnf_bounds_batch_kernel (disjunctive tables with interval bounds). One
// kernel covers all three: the conjunctive form arrives as D = 1 with every
// live-disjunct count 1 and no bounds.
//
// What bounds it on the H100: integer instructions. The bytes are few (the
// (n, F) int32 metadata read once, ceil(n/32) words written per query:
// 14.7 MB for Q = 256 over 105,100 x 27, 4.4 us at 3.35 TB/s), but every
// (query, row, clause) is a test: load the row's code, range-check it,
// fetch the allowed word it indexes, extract its bit. That is ~9 integer
// instructions per test, and each (query, 32-row word) adds loop, vote and
// ballot work; the H100 issues 64 integer lanes a clock per SM, half its
// fp32 rate. A first port that read `meta[row * F + f]` once per query
// from global memory also touched a 32-byte sector for every 4 bytes it
// used (~1.7 GB of L2 traffic at Q = 256). The TPU version avoided that by
// putting the queries on the fast grid axis, so a (tile, F) metadata block
// stays put while every query sweeps it.
//
// K1's design does the same: a block owns a tile of 128 or 256
// contiguous metadata rows, copies it once into shared memory (16-byte
// cp.async where the row stride F is odd and the base aligned, else 4-byte
// copies into a row stride padded to odd, so a warp's 32 rows fall in 32
// banks), and sweeps every query of its query group over it: grid (tiles,
// query groups), from the host's filter_plan. Each warp takes its own
// queries over the whole tile, a lane testing 4 or 8 rows, so a clause's
// field, bounds and table row are read once for all of them and the
// warp's chain of queries stays short. The group's fields, live-disjunct
// counts and bounds come into shared memory a chunk of queries at a time,
// the next chunk's cp.async copies in flight while the current one is
// swept; the allowed words are read through the L1 (__ldg), since staging
// every query's Wv words in every block moved more bytes from L2 than the
// metadata itself. A failed row runs on with its warp (no divergence); a
// warp ends a query once all of its rows pass. The warp's pass flags become
// the output words through __ballot_sync, and lanes 0..kRows-1 store the
// tile's words of a query in one coalesced store, no atomics. The TPU
// version expanded each clause's value bitmap to a dense table and ran an
// iota-compare over (tile, v_cap) because a TPU has no cheap gather; a
// thread here probes one bit of the packed allowed words instead, so the
// work per row is O(clauses), not O(clauses * v_cap). Rows >= n never
// pass, so the tail word's pad bits are 0.
//
// K4 filter_eval replaces the Pallas kernel behind
// src/repro/kernels/filter_eval.py filter_eval (_kernel): one query, a
// conjunctive (C,) fields row (-1 inactive) and a dense (C, v_cap) uint8
// allowed table, one 1 per allowed code. Bound by bytes (the named
// metadata columns in, ceil(n/32) words out): the byte table sits in
// shared memory, a thread tests one row read straight from global memory,
// and the warp packs its 32 flags with __ballot_sync. Rows >= n never
// pass, so the pad bits of the last word are 0 even when no clause is
// active (the Pallas kernel leaves them set there; its jnp oracle clears
// them). A row is read only up to its first failing clause, so a call
// moves the first active column's sectors and the later columns' sectors
// of the rows still passing; streaming whole rows through a cp.async ring
// in shared memory moves every byte of the metadata and measured slower
// on the H100 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;

// K1: grid (ceil(n / kTile), ceil(Q / group)), kWarps warps a block, kTile =
// 32 * kRows metadata rows a block. Dynamic shared memory: the tile (row r
// at s_meta + r * stride, stride = F | 1, rounded up to 16 bytes), then two
// buffers of `chunk` queries (buf_ints ints each) holding, per query, D*C
// fields, then the chunk's live-disjunct counts, then (kBounds) D*C*2
// bounds per query. Warp w sweeps queries w, w + kWarps, ... of each chunk
// over the whole tile; lane l tests rows l + 32 * i for i < kRows.
template <int kRows, bool kBounds>
__global__ void __launch_bounds__(kWarps * 32) filter_eval_batch_kernel(
    const int* __restrict__ meta, int n, int F, int stride, int vec4,
    const int* __restrict__ fields, const int* __restrict__ allowed,
    const int* __restrict__ bounds, const int* __restrict__ n_disj, int Q,
    int D, int C, int Wv, int W, int group, int chunk, int buf_ints,
    unsigned int* __restrict__ out) {
  constexpr int kTile = 32 * kRows;
  extern __shared__ int4 s_dyn4[];
  int* s_meta = reinterpret_cast<int*>(s_dyn4);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kTile;
  const int n_here = min(kTile, n - row0);

  // the tile, n_here rows of F codes contiguous in global memory: the
  // first copy group, overlapped with the first chunk of tables
  const int* src = meta + (size_t)row0 * F;
  if (vec4) {  // stride == F: one contiguous copy, its tail zero-filled
    const int bytes = n_here * F * 4;
    for (int i = tid; i * 16 < bytes; i += nt)
      ptx::copy16(s_meta + 4 * i, src + 4 * i, min(16, bytes - 16 * i));
  } else {  // an unaligned base or a padded stride: 4-byte copies
    for (int i = tid; i < n_here * F; i += nt) {
      const int r = i / F;
      ptx::copy4(s_meta + r * stride + (i - r * F), src + i, 4);
    }
  }
  ptx::commit();

  const int dc = D * C;
  const unsigned v_cap = Wv * 32;
  // buffer b starts at s_buf + b * buf_ints: fields, live-disjunct counts,
  // bounds
  int* s_buf = s_meta + ((kTile * stride + 3) & ~3);
  const int off_nd = chunk * dc;
  const int off_bounds = off_nd + chunk;

  // copies of queries [qc, qc + nq) into buffer b, one commit group
  auto issue = [&](int qc, int nq, int b) {
    int* dst = s_buf + b * buf_ints;
    for (int i = tid; i < nq * dc; i += nt)
      ptx::copy4(dst + i, fields + (size_t)qc * dc + i, 4);
    for (int i = tid; i < nq; i += nt)
      ptx::copy4(dst + off_nd + i, n_disj + qc + i, 4);
    if (kBounds)
      for (int i = tid; i < nq * dc * 2; i += nt)
        ptx::copy4(dst + off_bounds + i, bounds + (size_t)qc * dc * 2 + i,
                   4);
    ptx::commit();
  };

  const int word0 = row0 >> 5;
  const int q_begin = blockIdx.y * group;
  const int q_end = min(Q, q_begin + group);
  const int* m_lane = s_meta + lane * stride;  // row lane + 32 * i is
  const int row_step = 32 * stride;            // at m_lane + i * row_step
  unsigned live[kRows];                        // 1 where that row is < n
#pragma unroll
  for (int i = 0; i < kRows; ++i) live[i] = lane + 32 * i < n_here;
  // lane i < kRows stores the tile's word i of each query
  unsigned int* out_lane = out + word0 + lane;
  const bool store = lane < kRows && word0 + lane < W;

  issue(q_begin, min(chunk, q_end - q_begin), 0);
  for (int qc = q_begin, b = 0; qc < q_end; qc += chunk, b ^= 1) {
    const int nq = min(chunk, q_end - qc);
    if (qc + chunk < q_end) {  // the next chunk's copies go out first
      issue(qc + chunk, min(chunk, q_end - qc - chunk), b ^ 1);
      ptx::wait_group<1>();
    } else {
      ptx::wait_group<0>();
    }
    __syncthreads();  // the tile and this chunk are visible to every warp
    const int* buf = s_buf + b * buf_ints;
    unsigned int* out_q = out_lane + (size_t)(qc + warp) * W;
    for (int j = warp; j < nq; j += kWarps) {
      const int* a_q = allowed + (size_t)(qc + j) * dc * Wv;
      const int* f_q = buf + j * dc;
      const int* b_q = buf + off_bounds + j * dc * 2;
      const int nd = min(buf[off_nd + j], D);
      unsigned ok[kRows];  // 1 where row lane + 32 * i passes
#pragma unroll
      for (int i = 0; i < kRows; ++i) ok[i] = 0;
      for (int d = 0; d < nd; ++d) {
        unsigned ok_d[kRows];  // rows that pass an earlier disjunct are done
#pragma unroll
        for (int i = 0; i < kRows; ++i) ok_d[i] = live[i] & ~ok[i];
        for (int c = 0; c < C; ++c) {
          const int t = d * C + c;
          const int f = f_q[t];
          if (f < 0) continue;  // inactive clause (-1) or dead disjunct (-2)
          const int* col = m_lane + f;
          if (kBounds && b_q[2 * t] <= b_q[2 * t + 1]) {
            // interval clause: col >= 0 and lo <= col <= hi
            const int lo = max(b_q[2 * t], 0);
            const unsigned span = static_cast<unsigned>(b_q[2 * t + 1] - lo);
            const unsigned none = lo > b_q[2 * t + 1] ? 0u : 1u;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              ok_d[i] &= none & (static_cast<unsigned>(col[i * row_step]) -
                                     static_cast<unsigned>(lo) <=
                                 span);
          } else {
            const int* a_t = a_q + t * Wv;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              // -1 and codes >= v_cap fail (as unsigned, -1 is >= v_cap)
              const unsigned u = static_cast<unsigned>(col[i * row_step]);
              const unsigned w =
                  u < v_cap ? static_cast<unsigned>(__ldg(a_t + (u >> 5)))
                            : 0u;
              ok_d[i] &= __funnelshift_r(w, w, u);  // bit u % 32 of w
            }
          }
        }
        unsigned todo = 0;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          ok[i] |= ok_d[i];
          todo |= live[i] & ~ok[i];
        }
        // the warp stops once all of its rows pass (a warp-uniform vote)
        if (d + 1 < nd && !__any_sync(kFull, todo)) break;
      }
      // word i of the tile to lane i: one coalesced store of kRows words
      unsigned mine = 0;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned word = __ballot_sync(kFull, ok[i]);
        if (lane == i) mine = word;
      }
      if (store) *out_q = mine;
      out_q += kWarps * W;
    }
    __syncthreads();  // every warp is done with buffer b before its refill
  }
}

template <int kRows, bool kBounds>
int launch_batch(const int* meta, int n, int F, int stride, int vec4,
                 const int* fields, const int* allowed, const int* bounds,
                 const int* n_disj, int Q, int D, int C, int Wv, int W,
                 int group, int chunk, int buf_ints, int smem_bytes,
                 unsigned int* out, cudaStream_t stream) {
  const auto kernel = filter_eval_batch_kernel<kRows, kBounds>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int kTile = 32 * kRows;
  const dim3 grid((n + kTile - 1) / kTile, (Q + group - 1) / group);
  kernel<<<grid, kWarps * 32, smem_bytes, stream>>>(
      meta, n, F, stride, vec4, fields, allowed, bounds, n_disj, Q, D, C, Wv,
      W, group, chunk, buf_ints, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBounds>
int launch_rows(int rows, const int* meta, int n, int F, int stride,
                int vec4, const int* fields, const int* allowed,
                const int* bounds, const int* n_disj, int Q, int D, int C,
                int Wv, int W, int group, int chunk, int buf_ints,
                int smem_bytes, unsigned int* out, cudaStream_t stream) {
  switch (rows) {
    case 128:
      return launch_batch<4, kBounds>(meta, n, F, stride, vec4, fields,
                                      allowed, bounds, n_disj, Q, D, C, Wv, W,
                                      group, chunk, buf_ints, smem_bytes, out,
                                      stream);
    default:
      return launch_batch<8, kBounds>(meta, n, F, stride, vec4, fields,
                                      allowed, bounds, n_disj, Q, D, C, Wv, W,
                                      group, chunk, buf_ints, smem_bytes, out,
                                      stream);
  }
}

__global__ void filter_eval_kernel(const int* __restrict__ meta, int n, int F,
                                   const int* __restrict__ fields,
                                   const unsigned char* __restrict__ allowed,
                                   int C, int v_cap, int W,
                                   unsigned int* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_fields = smem;
  unsigned char* s_allowed = reinterpret_cast<unsigned char*>(s_fields + C);
  for (int i = threadIdx.x; i < C; i += blockDim.x) s_fields[i] = fields[i];
  for (int i = threadIdx.x; i < C * v_cap; i += blockDim.x)
    s_allowed[i] = allowed[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * kWarps + warp; w < W; w += gridDim.x * kWarps) {
    const int row = w * 32 + lane;
    bool ok = row < n;
    if (ok) {
      const int* m = meta + (size_t)row * F;
      for (int c = 0; c < C && ok; ++c) {
        const int f = s_fields[c];
        if (f < 0) continue;  // inactive clause
        const int col = __ldg(m + f);
        ok = col >= 0 && col < v_cap && s_allowed[c * v_cap + col] != 0;
      }
    }
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) out[w] = word;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// metadata (n, F) i32; fields (Q, D, C) i32; allowed (Q, D, C, Wv) i32
// words; bounds (Q, D, C, 2) i32 or null; n_disj (Q,) i32; out (Q, W) i32
// with W = ceil(n/32). rows (128 or 256) metadata rows per block,
// group queries per block and smem_bytes of dynamic shared memory (the
// wrapper's filter_plan): the tile takes rows * (F | 1) ints rounded up to
// 16 bytes, the rest two buffers of the tables of as many queries as fit
// (at least one each). Launches on `stream`; returns cudaGetLastError().
extern "C" int filter_eval_batch_launch(const void* meta, int n, int F,
                                        const void* fields, const void* allowed,
                                        const void* bounds, const void* n_disj,
                                        int Q, int D, int C, int Wv, int rows,
                                        int group, int smem_bytes, void* out,
                                        void* stream) {
  const int W = (n + 31) / 32;
  if (Q == 0 || W == 0) return 0;
  const int stride = F | 1;  // odd: a warp's 32 rows in 32 banks
  const int per_q = D * C * (1 + (bounds ? 2 : 0)) + 1;
  const long long avail =
      smem_bytes / 4 - ((static_cast<long long>(rows) * stride + 3) & ~3LL);
  const long long fit = (avail / 2 - 3) / per_q;
  if ((rows != 128 && rows != 256) || group < 1 || fit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = static_cast<int>(fit < group ? fit : group);
  const int buf_ints = (chunk * per_q + 3) & ~3;
  const int vec4 =
      stride == F && reinterpret_cast<uintptr_t>(meta) % 16 == 0;
  const auto m = static_cast<const int*>(meta);
  const auto f = static_cast<const int*>(fields);
  const auto a = static_cast<const int*>(allowed);
  const auto b = static_cast<const int*>(bounds);
  const auto nd = static_cast<const int*>(n_disj);
  const auto o = static_cast<unsigned int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (b)
    return launch_rows<true>(rows, m, n, F, stride, vec4, f, a, b, nd, Q, D,
                             C, Wv, W, group, chunk, buf_ints, smem_bytes, o,
                             st);
  return launch_rows<false>(rows, m, n, F, stride, vec4, f, a, b, nd, Q, D, C,
                            Wv, W, group, chunk, buf_ints, smem_bytes, o,
                            st);
}

// metadata (n, F) i32; fields (C,) i32 (-1 inactive); allowed (C, v_cap)
// uint8; out (W,) i32 with W = ceil(n/32). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int filter_eval_launch(const void* meta, int n, int F,
                                  const void* fields, const void* allowed,
                                  int C, int v_cap, void* out, void* stream) {
  const int W = (n + 31) / 32;
  if (W == 0) return 0;
  const size_t smem =
      static_cast<size_t>(C) * sizeof(int) + static_cast<size_t>(C) * v_cap;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filter_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // one word per warp; enough blocks to cover every SM several times over
  const int blocks = min((W + kWarps - 1) / kWarps, 132 * 8);
  filter_eval_kernel<<<blocks, kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), n, F, static_cast<const int*>(fields),
      static_cast<const unsigned char*>(allowed), C, v_cap, W,
      static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
