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
// What bounds it on the H100: with a dense mask, operations (2*Q*n*d fp32
// FMAs on the CUDA cores; no tensor cores yet). On the search path the
// mask of each call is one atlas cluster per query (a fraction of a percent
// of the rows), and then bytes: only the rows some query of the tile can
// pass need to be read. The design follows from that: a pass-1 block first
// ORs its queries' bitmap words over its chunk and compacts the rows whose
// union bit is set into a list in shared memory, then runs a shared-memory
// tiled fp32 product over the gathered rows only. A chunk no query of the
// tile passes costs one bitmap read; a dense mask degenerates to the plain
// tiled product.
//
// Top-k: warp w of a block owns query w of the tile and keeps its top-k
// (k <= 32) in registers, lane i holding the i-th best (score, id).
// Candidates reach the list in increasing id order, so a candidate enters
// only if its score is strictly above the current k-th score, and it goes
// after every entry with an equal score: exactly "ties to the lower id",
// the order the Pallas running merge (lax.top_k) produced.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQT = 8;          // queries per block (= warps per block)
constexpr int kBN = 64;         // gathered rows per score tile
constexpr int kBK = 32;         // depth slice per shared-memory stage
constexpr int kChunk = 2048;    // corpus rows per pass-1 block
constexpr int kChunkWords = kChunk / 32;
constexpr int kThreads = kQT * 32;

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

__global__ void __launch_bounds__(kThreads) topk_partial_kernel(
    const float* __restrict__ queries, const float* __restrict__ corpus,
    const unsigned int* __restrict__ bitmap, int Q, int n, int d, int W,
    int k, int n_chunks, int vec4, float* __restrict__ part_s,
    int* __restrict__ part_i) {
  __shared__ unsigned s_words[kQT][kChunkWords];
  __shared__ int s_count[kChunkWords];
  __shared__ int s_rows[kChunk];
  __shared__ float s_q[kQT][kBK];
  __shared__ float s_x[kBN][kBK + 1];
  __shared__ int s_total;

  const int q0 = blockIdx.x * kQT;
  const int chunk = blockIdx.y;
  const int w0 = chunk * kChunkWords;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. the tile's bitmap words over this chunk (bits of rows >= n cleared)
  for (int i = tid; i < kQT * kChunkWords; i += kThreads) {
    const int qq = i / kChunkWords, ww = i % kChunkWords;
    const int q = q0 + qq, w = w0 + ww;
    unsigned word = 0;
    if (q < Q && w < W) {
      word = __ldg(bitmap + (size_t)q * W + w);
      const int rem = n - w * 32;
      if (rem <= 0) {
        word = 0;
      } else if (rem < 32) {
        word &= (1u << rem) - 1u;
      }
    }
    s_words[qq][ww] = word;
  }
  __syncthreads();
  // 2. compact the rows any query of the tile passes, in id order
  unsigned uni = 0;
  if (tid < kChunkWords) {
    for (int qq = 0; qq < kQT; ++qq) uni |= s_words[qq][tid];
    s_count[tid] = __popc(uni);
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int ww = 0; ww < kChunkWords; ++ww) {
      const int c = s_count[ww];
      s_count[ww] = run;
      run += c;
    }
    s_total = run;
  }
  __syncthreads();
  if (tid < kChunkWords) {
    int off = s_count[tid];
    const int base_row = (w0 + tid) * 32;
    while (uni) {
      const int b = __ffs(uni) - 1;
      uni &= uni - 1;
      s_rows[off++] = base_row + b;
    }
  }
  __syncthreads();
  const int total = s_total;

  // 3. tiled fp32 product over the gathered rows + per-warp running top-k
  const int q = q0 + warp;
  float ls = -INFINITY;
  int li = -1;
  for (int base = 0; base < total; base += kBN) {
    float acc0 = 0.f, acc1 = 0.f;
    for (int k0 = 0; k0 < d; k0 += kBK) {
      {
        const int qq = tid / kBK, kk = tid % kBK;
        const int qi = q0 + qq;
        s_q[qq][kk] = (qi < Q && k0 + kk < d)
                          ? __ldg(queries + (size_t)qi * d + k0 + kk) : 0.f;
      }
      if (vec4) {
        for (int i = tid; i < kBN * kBK / 4; i += kThreads) {
          const int r = i / (kBK / 4), c4 = i % (kBK / 4);
          const int rr = base + r;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rr < total && k0 + c4 * 4 < d)
            v = __ldg(reinterpret_cast<const float4*>(
                          corpus + (size_t)s_rows[rr] * d + k0) + c4);
          s_x[r][c4 * 4 + 0] = v.x;
          s_x[r][c4 * 4 + 1] = v.y;
          s_x[r][c4 * 4 + 2] = v.z;
          s_x[r][c4 * 4 + 3] = v.w;
        }
      } else {
        for (int i = tid; i < kBN * kBK; i += kThreads) {
          const int r = i / kBK, c = i % kBK;
          const int rr = base + r;
          s_x[r][c] = (rr < total && k0 + c < d)
                          ? __ldg(corpus + (size_t)s_rows[rr] * d + k0 + c)
                          : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float a = s_q[warp][kk];
        acc0 += a * s_x[lane][kk];
        acc1 += a * s_x[lane + 32][kk];
      }
      __syncthreads();
    }
    // this warp's query keeps a gathered row only if its own bit is set
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = base + half * 32 + lane;
      bool ok = false;
      int id = -1;
      if (rr < total && q < Q) {
        id = s_rows[rr];
        ok = (s_words[warp][(id >> 5) - w0] >> (id & 31)) & 1u;
      }
      offer(ls, li, ok, half ? acc1 : acc0, id, k, lane);
    }
  }
  if (q < Q && lane < k) {
    const size_t o = ((size_t)q * n_chunks + chunk) * k + lane;
    part_s[o] = ls;
    part_i[o] = li;
  }
}

__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int Q,
    int n_chunks, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kQT + warp;
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

extern "C" int masked_cosine_topk_chunks(int n) {
  return (n + kChunk - 1) / kChunk;
}

// queries (Q, d) f32; corpus (n, d) f32; bitmap (Q, W) i32 words with
// W >= ceil(n/32); k in [1, 32]; part_s/part_i scratch of
// Q * masked_cosine_topk_chunks(n) * k entries; out_s (Q, k) f32, out_i
// (Q, k) i32. vec4 != 0 promises d % 4 == 0 and a 16-byte aligned corpus.
// Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int masked_cosine_topk_launch(const void* queries, const void* corpus,
                                         const void* bitmap, int Q, int n, int d,
                                         int W, int k, int vec4, void* part_s,
                                         void* part_i, void* out_s, void* out_i,
                                         void* stream) {
  if (Q == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    const dim3 grid((Q + kQT - 1) / kQT, n_chunks);
    topk_partial_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(queries), static_cast<const float*>(corpus),
        static_cast<const unsigned int*>(bitmap), Q, n, d, W, k, n_chunks,
        vec4, static_cast<float*>(part_s), static_cast<int*>(part_i));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  topk_merge_kernel<<<(Q + kQT - 1) / kQT, kThreads, 0, st>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i), Q,
      n_chunks, k, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
