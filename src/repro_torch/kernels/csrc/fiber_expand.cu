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
// K2's design: a block owns one query and a span of its R neighbour slots
// (the wrapper splits R so that even Q = 64 gives every SM two blocks or
// more). The query vector is staged once per block by 16-byte cp.async
// copies, issued first and overlapped with the first row copies. The
// block's pad ids (-1, most of the slots on the walk) are written as -inf
// at once and compacted away with a ballot, so no warp waits on them; each
// valid id's pass bit is probed in the same step. Each warp then walks its
// share of the valid rows with two row buffers in shared memory: the next
// row's copy (16-byte cp.async, 512 contiguous bytes per warp instruction)
// is in flight while the current row is dotted against the staged query,
// so a block of four warps keeps up to 64 KB of rows in flight and three
// blocks fit on an SM (73 KB of shared memory each at d = 2048).
//
// K5 keeps the first port's kernel (the template below, used for K5
// alone): one warp per (q, r) reading the row with float4 loads against a
// query staged per block of 8 neighbours, probing the pass bit first and
// skipping the row read where it is 0 (its output is -inf whatever the
// dot), so it moves only the rows that pass.
#include <cuda_runtime.h>
#include <math.h>

#include "ptx.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWalkThreads = 128;
constexpr int kSlots = 2;  // row buffers per warp

// d floats from src to dst (shared), copy t of nt: 16-byte copies when
// vec4, else 4-byte ones
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int d,
                                         int vec4, int t, int nt) {
  if (vec4) {
    for (int i = t; i < d / 4; i += nt)
      ptx::copy16(dst + 4 * i, src + 4 * i, 16);
  } else {
    for (int i = t; i < d; i += nt) ptx::copy4(dst + i, src + i, 4);
  }
}

// K2: grid (ceil(R / span), Q), blockDim = 32 * warps (<= 128); dynamic
// shared memory (1 + kSlots * warps) * ceil4(d) floats: the query, then
// kSlots row buffers per warp.
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

  // the query vector: every thread's first copy group
  copy_vec(s_q, q_vecs + (size_t)q * d, d, vec4, tid, blockDim.x);
  ptx::commit();
  bool q_ready = false;
  for (int w0 = r_begin; w0 < r_end; w0 += blockDim.x) {
    // pad ids are written at once; the valid ones are compacted in slot
    // order with their pass bits
    const int r = w0 + tid;
    const int nid = r < r_end ? __ldg(ids + qr + r) : -1;
    const bool valid = nid >= 0;
    if (r < r_end && !valid) {
      sims[qr + r] = -INFINITY;
      sims_pass[qr + r] = -INFINITY;
    }
    const unsigned bal = __ballot_sync(kFull, valid);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int c = s_count[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (valid) {
      const int p = off + __popc(bal & ((1u << lane) - 1u));
      s_nid[p] = nid;
      s_pos[p] = r;
      s_pass[p] = (__ldg(q_bits + (nid >> 5)) >> (nid & 31)) & 1u;
    }
    __syncthreads();
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
    if (!q_ready) {  // the query group is complete and visible to all
      ptx::wait_group<kSlots - 1>();
      __syncthreads();
      q_ready = true;
    }
    for (int i = 0, j = warp; j < total; ++i, j += n_warps) {
      issue(i + kSlots - 1);
      ptx::commit();
      ptx::wait_group<kSlots - 1>();
      __syncwarp();
      const float* cur = slots + (i % kSlots) * dp;
      float acc = 0.f;
      if (vec4) {
        const float4* a4 = reinterpret_cast<const float4*>(cur);
        const float4* b4 = reinterpret_cast<const float4*>(s_q);
        for (int c = lane; c < d / 4; c += 32) {
          const float4 a = a4[c];
          const float4 b = b4[c];
          acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
        }
      } else {
        for (int c = lane; c < d; c += 32) acc += cur[c] * s_q[c];
      }
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) {
        sims[qr + s_pos[j]] = acc;
        sims_pass[qr + s_pos[j]] = s_pass[j] ? acc : -INFINITY;
      }
      __syncwarp();  // every lane is done with `cur` before it is refilled
    }
    __syncthreads();  // the compacted lists are rewritten by the next window
  }
}

// K5 below: the first port's kernel, one warp per (q, r)
constexpr int kWarps = 8;

// kWalk: K2 (both outputs, every valid row read); else K5 (sims_pass
// only, rows read only where the pass bit is set; sims is unused)
template <bool kWalk>
__global__ void fiber_expand_kernel(
    const float* __restrict__ q_vecs, const float* __restrict__ corpus,
    const int* __restrict__ ids, const unsigned int* __restrict__ bitmap,
    int R, int d, int W, int vec4, float* __restrict__ sims,
    float* __restrict__ sims_pass) {
  extern __shared__ float4 s_q4[];
  float* s_q = reinterpret_cast<float*>(s_q4);
  const int q = blockIdx.y;
  const float* qv = q_vecs + (size_t)q * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s_q[i] = qv[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= R) return;  // warp-uniform
  const int nid = ids[(size_t)q * R + r];
  float s_all = -INFINITY;
  float s_pass = -INFINITY;
  // warp-uniform: every lane read the same id and the same bitmap word
  const bool pass =
      nid >= 0 && ((__ldg(bitmap + (size_t)q * W + (nid >> 5)) >> (nid & 31)) & 1u);
  if (nid >= 0 && (kWalk || pass)) {
    const float* row = corpus + (size_t)nid * d;
    float acc = 0.f;
    if (vec4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int i = lane; i < d / 4; i += 32) {
        const float4 a = __ldg(row4 + i);
        const float4 b = s_q4[i];
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
      for (int i = lane; i < d; i += 32) acc += __ldg(row + i) * s_q[i];
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    s_all = acc;
    if (pass) s_pass = acc;
  }
  if (lane == 0) {
    if (kWalk) sims[(size_t)q * R + r] = s_all;
    sims_pass[(size_t)q * R + r] = s_pass;
  }
}

template <bool kWalk>
int launch(const void* q_vecs, const void* corpus, const void* ids,
           const void* bitmap, int Q, int R, int d, int W, int vec4,
           void* sims, void* sims_pass, void* stream) {
  if (Q == 0 || R == 0) return 0;
  const size_t smem = ((static_cast<size_t>(d) + 3) / 4) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fiber_expand_kernel<kWalk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + kWarps - 1) / kWarps, Q);
  fiber_expand_kernel<kWalk><<<grid, kWarps * 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_vecs), static_cast<const float*>(corpus),
      static_cast<const int*>(ids), static_cast<const unsigned int*>(bitmap),
      R, d, W, vec4, static_cast<float*>(sims),
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
// ceil4(d) * 4 of dynamic shared memory (the wrapper's plan, two row
// buffers per warp). vec4 != 0
// promises d % 4 == 0 and 16-byte aligned q_vecs/corpus. Returns
// cudaGetLastError().
extern "C" int fiber_expand_walk_launch(const void* q_vecs, const void* corpus,
                                        const void* ids, const void* bitmap,
                                        int Q, int R, int d, int W, int warps,
                                        int span, int smem_bytes, int vec4,
                                        void* sims, void* sims_pass,
                                        void* stream) {
  if (Q == 0 || R == 0) return 0;
  const long long need = (1LL + kSlots * warps) * ((d + 3) / 4) * 16;
  if (warps < 1 || warps * 32 > kMaxWalkThreads || span < 1 ||
      smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fiber_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + span - 1) / span, Q);
  fiber_walk_kernel<<<grid, warps * 32, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_vecs), static_cast<const float*>(corpus),
      static_cast<const int*>(ids), static_cast<const unsigned int*>(bitmap),
      R, d, W, span, vec4, static_cast<float*>(sims),
      static_cast<float*>(sims_pass));
  return static_cast<int>(cudaGetLastError());
}

// The same arguments as fiber_expand_walk_launch with one output: sims
// (Q, R) f32, -inf unless the id is >= 0 and its pass bit is set.
extern "C" int fiber_expand_launch(const void* q_vecs, const void* corpus,
                                   const void* ids, const void* bitmap, int Q,
                                   int R, int d, int W, int vec4, void* sims,
                                   void* stream) {
  return launch<false>(q_vecs, corpus, ids, bitmap, Q, R, d, W, vec4, nullptr,
                       sims, stream);
}
