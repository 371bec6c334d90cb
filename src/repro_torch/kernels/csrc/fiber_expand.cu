// K2 fiber_expand_walk: neighbour gather + dot + in-register pass-bit probe,
// and K5 fiber_expand, its one-output form.
//
// Replaces the Pallas kernels behind src/repro/kernels/fiber_expand.py
// fiber_expand_walk (_walk_kernel) and fiber_expand (_kernel). For each
// (q, r) K2 dots the corpus row ids[q, r] with q_vecs[q] and writes two
// (Q, R) outputs: sims (-inf only for id -1) and sims_pass (also -inf where
// the id's pass bit is 0), so the walk never loads a separate bool pass
// mask. K5 writes only the second output.
//
// What bounds it on the H100: bytes. Every valid (q, r) reads one d-float
// row of the corpus from a data-dependent address (2 flops per 4 bytes), so
// the kernel is a gather limited by memory traffic, and at the walk's sizes
// (Q = 64..256, R = 96, d = 2048: 8 KB rows, 10-26 MB a call) by how many
// bytes each SM keeps in flight. The TPU version DMA'd one (1, d) row per
// grid step through a scalar-prefetched id.
//
// The design: a block owns one query and a span of its R neighbour slots
// (the wrapper's walk_plan splits R so that even Q = 64 gives every SM two
// blocks or more). The slots a block reads a row for are compacted in slot
// order with a ballot, and every other slot is written -inf at once, so no
// warp waits on them: for K2 the valid ids (pad ids -1 are most of the
// slots on the walk), for K5 the ids that are valid AND whose pass bit is
// set (K5's output is -inf wherever the bit is 0, whatever the dot). The
// pass bit is probed in the same step. The query vector is staged once per
// block by 16-byte cp.async copies: K2 issues it first, overlapped with
// the id loads; K5 only once the compaction has found a slot to read, so a
// block of K5 with none (most of them: a few percent of a walk's ids pass)
// reads its ids and bitmap words and nothing else. Each warp then walks
// its share of the compacted rows with two row buffers in shared memory:
// the next row's copy (16-byte cp.async, 512 contiguous bytes per warp
// instruction) is in flight while the current row is dotted against the
// staged query, so a block of four warps keeps up to 64 KB of rows in
// flight and three blocks fit on an SM (73 KB of shared memory each at
// d = 2048).
#include <cuda_runtime.h>
#include <math.h>

#include "gather_dot.cuh"
#include "ptx.cuh"

namespace {

using gather::copy_vec;
using gather::kFull;
constexpr int kMaxWalkThreads = 128;
constexpr int kSlots = 2;  // row buffers per warp

// grid (ceil(R / span), Q), blockDim = 32 * warps (<= 128); dynamic
// shared memory (1 + kSlots * warps) * ceil4(d) floats: the query, then
// kSlots row buffers per warp. kWalk: K2 (both outputs, a row read for
// every valid id); else K5 (sims_pass only, a row read only where the id
// is valid and its pass bit set; sims is unused).
template <bool kWalk>
__global__ void __launch_bounds__(kMaxWalkThreads) fiber_walk_kernel(
    const float* __restrict__ q_vecs, const float* __restrict__ corpus,
    const int* __restrict__ ids, const unsigned int* __restrict__ bitmap,
    int R, int d, int W, int span, int vec4, float* __restrict__ sims,
    float* __restrict__ sims_pass) {
  extern __shared__ float4 s_dyn[];
  __shared__ int s_nid[kMaxWalkThreads];
  __shared__ int s_pos[kMaxWalkThreads];
  __shared__ int s_pass[kMaxWalkThreads];
  __shared__ int s_count[kMaxWalkThreads / 32];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int dp = (d + 3) & ~3;
  float* s_q = reinterpret_cast<float*>(s_dyn);
  float* slots = s_q + dp + (size_t)warp * kSlots * dp;
  const int q = blockIdx.y;
  const size_t qr = (size_t)q * R;
  const int r_begin = blockIdx.x * span;
  const int r_end = min(R, r_begin + span);
  const unsigned int* q_bits = bitmap + (size_t)q * W;

  // the query vector, every thread's first copy group: K2 at once, K5
  // once a slot passes
  const float* q_src = q_vecs + (size_t)q * d;
  bool q_issued = kWalk;
  if (kWalk) {
    copy_vec(s_q, q_src, d, vec4, tid, blockDim.x);
    ptx::commit();
  }
  bool q_ready = false;
  for (int w0 = r_begin; w0 < r_end; w0 += blockDim.x) {
    // the slots read no row for are written at once; the rest are
    // compacted in slot order with their pass bits
    const int r = w0 + tid;
    const int nid = r < r_end ? __ldg(ids + qr + r) : -1;
    // K5 takes a slot on its pass bit too; K2's bit is probed below
    const bool take =
        nid >= 0 &&
        (kWalk || ((__ldg(q_bits + (nid >> 5)) >> (nid & 31)) & 1u));
    if (r < r_end && !take) {
      if (kWalk) sims[qr + r] = -INFINITY;
      sims_pass[qr + r] = -INFINITY;
    }
    const unsigned bal = __ballot_sync(kFull, take);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = s_count[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (take) {
      const int p = off + __popc(bal & ((1u << lane) - 1u));
      s_nid[p] = nid;
      s_pos[p] = r;
      s_pass[p] =
          kWalk ? (__ldg(q_bits + (nid >> 5)) >> (nid & 31)) & 1u : 1u;
    }
    __syncthreads();
    if (!q_issued && total > 0) {  // block-uniform: K5's first taken slot
      copy_vec(s_q, q_src, d, vec4, tid, blockDim.x);
      ptx::commit();
      q_issued = true;
    }
    // warp w takes the compacted rows w, w + n_warps, ...: a ring of
    // kSlots row buffers keeps kSlots - 1 rows' copies in flight while the
    // current row is dotted
    auto issue = [&](int i) {  // the warp's i-th row of this window
      const int j = warp + i * n_warps;
      if (j < total)
        copy_vec(slots + (i % kSlots) * dp, corpus + (size_t)s_nid[j] * d, d,
                 vec4, lane, 32);
    };
#pragma unroll
    for (int i = 0; i < kSlots - 1; ++i) {
      issue(i);
      ptx::commit();
    }
    if (!q_ready && q_issued) {  // the query group is complete and visible
      ptx::wait_group<kSlots - 1>();
      __syncthreads();
      q_ready = true;
    }
    for (int i = 0, j = warp; j < total; ++i, j += n_warps) {
      issue(i + kSlots - 1);
      ptx::commit();
      ptx::wait_group<kSlots - 1>();
      __syncwarp();
      const float acc =
          gather::warp_dot(slots + (i % kSlots) * dp, s_q, d, vec4, lane);
      if (lane == 0) {
        if (kWalk) sims[qr + s_pos[j]] = acc;
        sims_pass[qr + s_pos[j]] = s_pass[j] ? acc : -INFINITY;
      }
      __syncwarp();  // every lane is done with `cur` before it is refilled
    }
    __syncthreads();  // the compacted lists are rewritten by the next window
  }
}

template <bool kWalk>
int launch(const void* q_vecs, const void* corpus, const void* ids,
           const void* bitmap, int Q, int R, int d, int W, int warps,
           int span, int smem_bytes, int vec4, void* sims, void* sims_pass,
           void* stream) {
  if (Q == 0 || R == 0) return 0;
  const long long need = (1LL + kSlots * warps) * ((d + 3) / 4) * 16;
  if (warps < 1 || warps * 32 > kMaxWalkThreads || span < 1 ||
      smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fiber_walk_kernel<kWalk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + span - 1) / span, Q);
  fiber_walk_kernel<kWalk><<<grid, warps * 32, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_vecs), static_cast<const float*>(corpus),
      static_cast<const int*>(ids), static_cast<const unsigned int*>(bitmap),
      R, d, W, span, vec4, static_cast<float*>(sims),
      static_cast<float*>(sims_pass));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2. q_vecs (Q, d) f32; corpus (n, d) f32; ids (Q, R) i32 (-1 pad); bitmap
// (Q, W) i32 words; sims, sims_pass (Q, R) f32. warps (1..4) per block,
// span neighbour slots per block, smem_bytes >= (1 + 2 * warps) *
// ceil4(d) * 4 of dynamic shared memory (the wrapper's walk_plan, two row
// buffers per warp). vec4 != 0 promises d % 4 == 0 and 16-byte aligned
// q_vecs/corpus. Returns cudaGetLastError().
extern "C" int fiber_expand_walk_launch(const void* q_vecs, const void* corpus,
                                        const void* ids, const void* bitmap,
                                        int Q, int R, int d, int W, int warps,
                                        int span, int smem_bytes, int vec4,
                                        void* sims, void* sims_pass,
                                        void* stream) {
  return launch<true>(q_vecs, corpus, ids, bitmap, Q, R, d, W, warps, span,
                      smem_bytes, vec4, sims, sims_pass, stream);
}

// K5. The same arguments as fiber_expand_walk_launch with one output: sims
// (Q, R) f32, -inf unless the id is >= 0 and its pass bit is set.
extern "C" int fiber_expand_launch(const void* q_vecs, const void* corpus,
                                   const void* ids, const void* bitmap, int Q,
                                   int R, int d, int W, int warps, int span,
                                   int smem_bytes, int vec4, void* sims,
                                   void* stream) {
  return launch<false>(q_vecs, corpus, ids, bitmap, Q, R, d, W, warps, span,
                       smem_bytes, vec4, nullptr, sims, stream);
}
