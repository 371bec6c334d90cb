// Row gather + dot device code shared by K2/K5 (fiber_expand.cu) and the
// walk round (walk_round.cu): a d-float corpus row copied into shared memory
// by cp.async, then dotted against a query staged in shared memory by one
// warp (float4 lanes, then a butterfly reduction).
#pragma once

#include "ptx.cuh"

namespace gather {

constexpr unsigned kFull = 0xffffffffu;

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

// The dot of a row and the query, both d floats in shared memory, by the 32
// lanes of one warp; every lane returns the whole sum.
__device__ __forceinline__ float warp_dot(const float* row, const float* q,
                                          int d, int vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(row);
    const float4* b4 = reinterpret_cast<const float4*>(q);
    for (int c = lane; c < d / 4; c += 32) {
      const float4 a = a4[c];
      const float4 b = b4[c];
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int c = lane; c < d; c += 32) acc += row[c] * q[c];
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

}  // namespace gather
