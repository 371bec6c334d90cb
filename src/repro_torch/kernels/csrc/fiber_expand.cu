// K2 fiber_expand_walk: neighbour gather + dot + in-register pass-bit probe.
//
// Replaces the Pallas kernel behind src/repro/kernels/fiber_expand.py
// fiber_expand_walk (_walk_kernel). For each (q, r) it dots the corpus row
// ids[q, r] with q_vecs[q] and writes two (Q, R) outputs: sims (-inf only
// for id -1) and sims_pass (also -inf where the id's pass bit is 0), so the
// walk never loads a separate bool pass mask.
//
// What bounds it on the H100: bytes. Every (q, r) reads one d-float row
// of the corpus from a data-dependent address (2 flops per 4 bytes), so the
// kernel is a gather limited by memory traffic. The TPU version DMA'd one
// (1, d) row per grid step through a scalar-prefetched id; here one warp
// owns one (q, r): its 32 lanes read the row as coalesced float4 loads
// (512 contiguous bytes per warp instruction), the query vector sits in
// shared memory for the whole block, the partial dots reduce with warp
// shuffles, and the pass bit is one word probe of the query's bitmap row.
// A block holds 8 warps = 8 neighbours of one query, so the query vector
// is loaded once per 8 rows.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__global__ void fiber_expand_walk_kernel(
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
  if (nid >= 0) {  // warp-uniform: every lane read the same id
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
    const unsigned word = __ldg(bitmap + (size_t)q * W + (nid >> 5));
    if ((word >> (nid & 31)) & 1u) s_pass = acc;
  }
  if (lane == 0) {
    sims[(size_t)q * R + r] = s_all;
    sims_pass[(size_t)q * R + r] = s_pass;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q_vecs (Q, d) f32; corpus (n, d) f32; ids (Q, R) i32 (-1 pad); bitmap
// (Q, W) i32 words; sims, sims_pass (Q, R) f32. vec4 != 0 promises d % 4
// == 0 and 16-byte aligned q_vecs/corpus. Returns cudaGetLastError().
extern "C" int fiber_expand_walk_launch(const void* q_vecs, const void* corpus,
                                        const void* ids, const void* bitmap,
                                        int Q, int R, int d, int W, int vec4,
                                        void* sims, void* sims_pass,
                                        void* stream) {
  if (Q == 0 || R == 0) return 0;
  const size_t smem = ((static_cast<size_t>(d) + 3) / 4) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fiber_expand_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((R + kWarps - 1) / kWarps, Q);
  fiber_expand_walk_kernel<<<grid, kWarps * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q_vecs), static_cast<const float*>(corpus),
      static_cast<const int*>(ids), static_cast<const unsigned int*>(bitmap),
      R, d, W, vec4, static_cast<float*>(sims),
      static_cast<float*>(sims_pass));
  return static_cast<int>(cudaGetLastError());
}
