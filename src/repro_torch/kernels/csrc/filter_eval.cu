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
// What bounds it on the H100: bytes. Each query's sweep reads the metadata
// columns its clauses name ((n, F) int32, reread per query from L2) and
// writes ceil(n/32) words; there is ~1 integer op per byte. The TPU
// version expanded each clause's value bitmap to a dense table and ran an
// iota-compare over (tile, v_cap) because a TPU has no cheap gather; a GPU
// thread probes one bit of the packed allowed words in shared memory
// instead, so the work per row is O(clauses), not O(clauses * v_cap).
//
// Design: grid (word groups, Q); one block = 8 warps; the block's query's
// clause tables (D*C fields, D*C*Wv allowed words, D*C*2 bounds) are
// staged in shared memory once and reused for every word the block
// writes. One thread per row, one warp per 32-row output word: the warp's
// pass flags become the word through __ballot_sync, so no atomics and no
// cross-thread packing. A row stops at its first passing disjunct and a
// disjunct at its first failing clause (the union is order-independent).
// Rows >= n never pass, so the tail word's pad bits are 0.
//
// K4 filter_eval replaces the Pallas kernel behind
// src/repro/kernels/filter_eval.py filter_eval (_kernel): one query, a
// conjunctive (C,) fields row (-1 inactive) and a dense (C, v_cap) uint8
// allowed table, one 1 per allowed code. Same bound (bytes: the named
// metadata columns in, ceil(n/32) words out) and the same design as K1: the
// byte table sits in shared memory, a thread tests one row, and the warp
// packs its 32 flags with __ballot_sync. Rows >= n never pass, so the pad
// bits of the last word are 0 even when no clause is active (the Pallas
// kernel leaves them set there; its jnp oracle clears them).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxGroupsPerQuery = 64;

__global__ void filter_eval_batch_kernel(
    const int* __restrict__ meta, int n, int F,
    const int* __restrict__ fields, const int* __restrict__ allowed,
    const int* __restrict__ bounds, const int* __restrict__ n_disj,
    int D, int C, int Wv, int W, unsigned int* __restrict__ out) {
  extern __shared__ int smem[];
  const int q = blockIdx.y;
  const int dc = D * C;
  int* s_fields = smem;
  int* s_allowed = s_fields + dc;
  int* s_bounds = s_allowed + dc * Wv;
  const int* f_q = fields + (size_t)q * dc;
  const int* a_q = allowed + (size_t)q * dc * Wv;
  for (int i = threadIdx.x; i < dc; i += blockDim.x) s_fields[i] = f_q[i];
  for (int i = threadIdx.x; i < dc * Wv; i += blockDim.x) s_allowed[i] = a_q[i];
  const bool has_bounds = bounds != nullptr;
  if (has_bounds) {
    const int* b_q = bounds + (size_t)q * dc * 2;
    for (int i = threadIdx.x; i < dc * 2; i += blockDim.x) s_bounds[i] = b_q[i];
  }
  __syncthreads();

  const int nd = min(n_disj[q], D);
  const int v_cap = Wv * 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // w is uniform across a warp, so every lane reaches the ballot
  for (int w = blockIdx.x * kWarps + warp; w < W; w += gridDim.x * kWarps) {
    const int row = w * 32 + lane;
    bool ok = false;
    if (row < n) {
      const int* m = meta + (size_t)row * F;
      for (int d = 0; d < nd && !ok; ++d) {
        bool ok_d = true;
        for (int c = 0; c < C && ok_d; ++c) {
          const int t = d * C + c;
          const int f = s_fields[t];
          if (f < 0) continue;  // inactive clause (-1) or dead disjunct (-2)
          const int col = __ldg(m + f);
          if (has_bounds && s_bounds[2 * t] <= s_bounds[2 * t + 1]) {
            ok_d = col >= 0 && col >= s_bounds[2 * t] &&
                   col <= s_bounds[2 * t + 1];
          } else {
            ok_d = col >= 0 && col < v_cap &&
                   ((static_cast<unsigned>(s_allowed[t * Wv + (col >> 5)]) >>
                     (col & 31)) & 1u);
          }
        }
        ok = ok_d;
      }
    }
    const unsigned word = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) out[(size_t)q * W + w] = word;
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
// with W = ceil(n/32). Launches on `stream`; returns cudaGetLastError().
extern "C" int filter_eval_batch_launch(const void* meta, int n, int F,
                                        const void* fields, const void* allowed,
                                        const void* bounds, const void* n_disj,
                                        int Q, int D, int C, int Wv, void* out,
                                        void* stream) {
  const int W = (n + 31) / 32;
  if (Q == 0 || W == 0) return 0;
  const size_t smem =
      static_cast<size_t>(D) * C * (1 + Wv + (bounds ? 2 : 0)) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filter_eval_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = min((W + kWarps - 1) / kWarps, kMaxGroupsPerQuery);
  const dim3 grid(groups, Q);
  filter_eval_batch_kernel<<<grid, kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), n, F, static_cast<const int*>(fields),
      static_cast<const int*>(allowed), static_cast<const int*>(bounds),
      static_cast<const int*>(n_disj), D, C, Wv, W,
      static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
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
