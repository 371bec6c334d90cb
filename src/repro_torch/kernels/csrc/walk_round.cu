// walk_round: one restart round of the batched drift-guided walk, every
// query lane walked to its own end in one launch.
//
// Replaces the reference's walk ``lax.while_loop`` around the Pallas K2
// kernel (src/repro/core/batched/engine.py:157-262, walk_batch, whose hops
// call fiber_expand_walk, src/repro/kernels/fiber_expand.py:79). Its plain
// version is the port's walk_batch (core/batched/engine.py), which runs the
// lanes in lockstep with PyTorch ops and reads "is any lane running" on the
// host. Lanes never exchange data: the lockstep only batches them, and a
// lane's outputs stop changing once it terminates. So here one block owns
// one lane and runs its hops until that lane terminates or max_hops, with
// walk_batch's termination order (converged, early, stall, max-hop), and no
// host read happens inside the round.
//
// Per lane the block keeps the frontier (F), beam (B) and result (k) queues
// in shared memory, with the hop's neighbour ids and distances. The
// visited bitmap is the lane's row of a (Q, ceil(n/32)) buffer in global
// memory (written with atomicOr, read through L2), so any n works; the
// in-results test is against the round's k carried result ids, which are
// fixed for the round.
//
// What bounds it on the H100: bytes. A hop reads one adjacency row and a
// d-float corpus row for each neighbour that is new or passes the filter
// (the only neighbours whose distance any output depends on), at 2 flops
// per 4 bytes, from data-dependent addresses. The row gather-dot is K2's
// device code (gather_dot.cuh): each of the block's gather warps takes
// every gw-th needed row, with a ring of two row buffers in shared memory so
// one row's cp.async copy is in flight while the other is dotted against
// the query staged once per block. The popped node's own distance vx is the
// value it was queued with, which the same dot gave, so its row is not read
// again.
//
// Tie order is walk_batch's: a queue merge keeps the cap smallest with
// queue entries first among equal values, then candidates in index order;
// a top-k keeps the smallest, ties to the lower index. Each entry's place
// is the count of entries that precede it in that order, computed by one
// thread an entry. A candidate masked to the sentinel (3.4e38) never
// enters: the cap queue entries, all at or below it, precede it.
#include <cuda_runtime.h>
#include <math.h>

#include "gather_dot.cuh"
#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;   // one neighbour slot a thread: R <= 256
constexpr int kMaxR = kThreads;
constexpr int kMaxQueue = 64;   // k, B, F caps
constexpr int kSlots = 2;       // row buffers per gather warp
constexpr float kInf = 3.4e38f;  // the engine's INF sentinel in float32
constexpr float kHalfInf = 1.7e38f;

enum { kRunning = 0, kConverged = 1, kEarly = 2, kStall = 3, kMaxHop = 4 };
enum { kValid = 1, kNew = 2, kPass = 4, kInRes = 8 };

struct Lane {
  int phase, stall, term, hops, p1_hops, x, uf, n_rows;
  int p1neg, to2, in2, reenter;
  float x_v;
};

// Keep the cap smallest of queue (q_v, q_i)[cap] and candidates
// (c_v, c_i)[m], queue entries first among equal values, then candidates in
// index order; o_v/o_i are cap-sized scratch. Every thread calls it.
__device__ void merge_queue(float* q_v, int* q_i, int cap, const float* c_v,
                            const int* c_i, int m, float* o_v, int* o_i) {
  const int n = cap + m;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const bool is_q = e < cap;
    const float v = is_q ? q_v[e] : c_v[e - cap];
    if (!is_q && !(v < kInf)) continue;  // ranks after all cap queue entries
    int rank = 0;
    for (int f = 0; f < n && rank < cap; ++f) {
      const float w = f < cap ? q_v[f] : c_v[f - cap];
      rank += (w < v) || (w == v && f < e);
    }
    if (rank < cap) {
      o_v[rank] = v;
      o_i[rank] = is_q ? q_i[e] : c_i[e - cap];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cap; e += blockDim.x) {
    q_v[e] = o_v[e];
    q_i[e] = o_i[e];
  }
  __syncthreads();
}

// The kf smallest of vals[R] (ties to the lower index) with their ids, in
// order, into t_v/t_i[kf]; the sentinel and -1 where fewer are below it.
__device__ void top_small(const float* vals, const int* ids, int R, int kf,
                          float* t_v, int* t_i) {
  for (int j = threadIdx.x; j < kf; j += blockDim.x) {
    t_v[j] = kInf;
    t_i[j] = -1;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R; e += blockDim.x) {
    const float v = vals[e];
    if (!(v < kInf)) continue;
    int rank = 0;
    for (int f = 0; f < R && rank < kf; ++f)
      rank += (vals[f] < v) || (vals[f] == v && f < e);
    if (rank < kf) {
      t_v[rank] = v;
      t_i[rank] = ids[e];
    }
  }
  __syncthreads();
}

// out[j] = row_id[j]'s corpus row . s_q for j < total: gather warp w (of
// gw) takes rows w, w + gw, ... through its kSlots row buffers. Every
// thread calls it.
__device__ void gather_dots(const float* __restrict__ corpus, int d, int dp,
                            int vec4, const float* s_q, float* slots,
                            const int* row_id, int total, int gw,
                            float* out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < gw) {
    float* mine = slots + (size_t)warp * kSlots * dp;
    auto issue = [&](int i) {
      const int j = warp + i * gw;
      if (j < total)
        gather::copy_vec(mine + (i % kSlots) * dp,
                         corpus + (size_t)row_id[j] * d, d, vec4, lane, 32);
    };
#pragma unroll
    for (int i = 0; i < kSlots - 1; ++i) {
      issue(i);
      ptx::commit();
    }
    for (int i = 0, j = warp; j < total; ++i, j += gw) {
      issue(i + kSlots - 1);
      ptx::commit();
      ptx::wait_group<kSlots - 1>();
      __syncwarp();
      const float acc =
          gather::warp_dot(mine + (i % kSlots) * dp, s_q, d, vec4, lane);
      if (lane == 0) out[j] = acc;
      __syncwarp();  // every lane is done with the buffer before its refill
    }
    ptx::wait_group<0>();
  }
  __syncthreads();
}

__device__ __forceinline__ bool bit(unsigned w, int i) {
  return (w >> (i & 31)) & 1u;
}

// grid (Q), blockDim kThreads; dynamic shared memory (1 + kSlots * gw) *
// ceil4(d) floats: the query, then each gather warp's row buffers.
__global__ void __launch_bounds__(kThreads) walk_round_kernel(
    const float* __restrict__ vectors, const int* __restrict__ adjacency,
    const unsigned* __restrict__ pass_bm, const float* __restrict__ q_vecs,
    const int* __restrict__ seeds, const float* __restrict__ res0_v,
    const int* __restrict__ res0_i, int d, int R, int W, int S, int k, int B,
    int F, int kf, int stall_budget, int max_hops, int vec4, int gw,
    float* __restrict__ res_v, int* __restrict__ res_i,
    int* __restrict__ term_out, int* __restrict__ hops_out,
    int* __restrict__ p1_out, unsigned* __restrict__ visited) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_fv[kMaxQueue], s_bv[kMaxQueue], s_rv[kMaxQueue];
  __shared__ int s_fi[kMaxQueue], s_bi[kMaxQueue], s_ri[kMaxQueue];
  __shared__ int s_r0i[kMaxQueue];
  __shared__ float s_mv[kMaxQueue];
  __shared__ int s_mi[kMaxQueue];
  __shared__ int s_nid[kMaxR];
  __shared__ float s_vn[kMaxR];
  __shared__ int s_row_id[kMaxR];
  __shared__ int s_row_out[kMaxR];
  __shared__ float s_dot[kMaxR];
  __shared__ float s_cv[kMaxQueue + kMaxR];
  __shared__ int s_ci[kMaxQueue + kMaxR];
  __shared__ float s_tv[kMaxR];
  __shared__ int s_ti[kMaxR];
  __shared__ int s_red_i[2 * (kThreads / 32)];
  __shared__ float s_red_f[kThreads / 32];
  __shared__ Lane st;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dp = (d + 3) & ~3;
  float* s_q = reinterpret_cast<float*>(s_dyn);
  float* slots = s_q + dp;
  const int q = blockIdx.x;
  const unsigned* pbits = pass_bm + (size_t)q * W;
  unsigned* vis = visited + (size_t)q * W;

  gather::copy_vec(s_q, q_vecs + (size_t)q * d, d, vec4, tid, nt);
  ptx::commit();
  for (int w = tid; w < W; w += nt) __stcg(vis + w, 0u);
  for (int i = tid; i < F; i += nt) {
    s_fv[i] = kInf;
    s_fi[i] = -1;
  }
  for (int i = tid; i < B; i += nt) {
    s_bv[i] = kInf;
    s_bi[i] = -1;
  }
  for (int i = tid; i < k; i += nt) {
    s_rv[i] = res0_v[(size_t)q * k + i];
    s_ri[i] = s_r0i[i] = res0_i[(size_t)q * k + i];
  }
  if (tid == 0) {
    st.phase = 1;
    st.stall = st.term = st.hops = st.p1_hops = st.n_rows = 0;
  }
  ptx::wait_group<0>();
  __syncthreads();

  // ---- seeds: distances, visited bits, the frontier and the results ----
  int sid = -1;
  if (tid < S) {
    sid = seeds[(size_t)q * S + tid];
    if (sid >= 0) {
      const int j = atomicAdd(&st.n_rows, 1);
      s_row_id[j] = sid;
      s_row_out[j] = tid;
    }
  }
  __syncthreads();
  gather_dots(vectors, d, dp, vec4, s_q, slots, s_row_id, st.n_rows, gw,
              s_dot);
  for (int j = tid; j < st.n_rows; j += nt)
    s_vn[s_row_out[j]] = 1.0f - s_dot[j];
  __syncthreads();
  if (tid < S) {
    const float seed_v = sid >= 0 ? s_vn[tid] : kInf;
    s_cv[tid] = seed_v;
    s_ci[tid] = sid;
    bool in_res = false;
    for (int j = 0; j < k; ++j) in_res |= sid >= 0 && s_r0i[j] == sid;
    const bool seed_pass =
        sid >= 0 && bit(__ldg(pbits + (sid >> 5)), sid) && !in_res;
    s_tv[tid] = seed_pass ? seed_v : kInf;
    s_ti[tid] = sid;
    if (sid >= 0) atomicOr(vis + (sid >> 5), 1u << (sid & 31));
  }
  __syncthreads();
  merge_queue(s_fv, s_fi, F, s_cv, s_ci, S, s_mv, s_mi);
  merge_queue(s_rv, s_ri, k, s_tv, s_ti, S, s_mv, s_mi);

  int t = 0;
  for (; t < max_hops; ++t) {
    // ---- pop one node; termination (phase-2 semantics) ----
    if (tid == 0) {
      const bool f_empty = s_fv[0] >= kHalfInf;
      const bool b_empty = s_bv[0] >= kHalfInf;
      if (st.phase == 1 && f_empty) st.phase = 2;
      const bool uf = st.phase == 1;
      float* qv = uf ? s_fv : s_bv;
      int* qi = uf ? s_fi : s_bi;
      const int cap = uf ? F : B;
      st.x_v = qv[0];
      st.x = qi[0];
      for (int i = 0; i + 1 < cap; ++i) {
        qv[i] = qv[i + 1];
        qi[i] = qi[i + 1];
      }
      qv[cap - 1] = kInf;
      qi[cap - 1] = -1;
      const float v_k = s_rv[k - 1];
      const bool nothing = uf ? (f_empty && b_empty) : b_empty;
      const bool early = !uf && st.x_v > v_k && v_k < kHalfInf;
      const bool stallout = !uf && st.stall >= stall_budget;
      st.term = nothing ? kConverged
                        : early ? kEarly : stallout ? kStall : kRunning;
      st.uf = uf;
      st.n_rows = 0;
    }
    __syncthreads();
    if (st.term != kRunning) break;

    // ---- expand x: neighbour flags, visited bits, the rows to dot ----
    const int x = max(st.x, 0);
    int nid = -1, fl = 0;
    if (tid < R) {
      nid = __ldg(adjacency + (size_t)x * R + tid);
      if (nid >= 0) {
        fl = kValid;
        if (!bit(__ldcg(vis + (nid >> 5)), nid)) fl |= kNew;
        if (bit(__ldg(pbits + (nid >> 5)), nid)) fl |= kPass;
        for (int j = 0; j < k; ++j)
          if (s_r0i[j] == nid) fl |= kInRes;
        if (fl & (kNew | kPass)) {
          const int j = atomicAdd(&st.n_rows, 1);
          s_row_id[j] = nid;
          s_row_out[j] = tid;
        }
      }
      s_nid[tid] = nid;
      s_vn[tid] = kInf;
    }
    __syncthreads();  // every seen bit is read before any is set
    if (fl & kNew) atomicOr(vis + (nid >> 5), 1u << (nid & 31));
    gather_dots(vectors, d, dp, vec4, s_q, slots, s_row_id, st.n_rows, gw,
                s_dot);
    for (int j = tid; j < st.n_rows; j += nt)
      s_vn[s_row_out[j]] = 1.0f - s_dot[j];
    __syncthreads();

    // ---- result candidates and the local signals ----
    const bool is_new = fl & kNew;
    const bool is_pass = fl & kPass;
    const float vn = tid < R ? s_vn[tid] : kInf;
    if (tid < R) {
      s_cv[tid] = is_new && is_pass && !(fl & kInRes) ? vn : kInf;
      s_ci[tid] = nid;
    }
    int c_pass = is_pass, c_nf = is_new && is_pass;
    float c_sum = is_pass ? vn : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      c_pass += __shfl_xor_sync(gather::kFull, c_pass, o);
      c_nf += __shfl_xor_sync(gather::kFull, c_nf, o);
      c_sum += __shfl_xor_sync(gather::kFull, c_sum, o);
    }
    if (lane == 0) {
      s_red_i[warp] = c_pass;
      s_red_i[kThreads / 32 + warp] = c_nf;
      s_red_f[warp] = c_sum;
    }
    __syncthreads();
    if (tid == 0) {
      int n_pass = 0, new_filt = 0;
      float sum = 0.f;
      for (int w = 0; w < nt / 32; ++w) {
        n_pass += s_red_i[w];
        new_filt += s_red_i[kThreads / 32 + w];
        sum += s_red_f[w];
      }
      const float drift =
          n_pass > 0 ? sum / (float)n_pass - st.x_v : INFINITY;
      const bool neg = drift < 0.f;
      st.stall = new_filt > 0 ? 0 : st.stall + 1;
      st.p1neg = st.phase == 1 && neg;
      st.to2 = st.phase == 1 && !neg;
      st.in2 = st.phase == 2;
      st.reenter = st.in2 && neg && new_filt > 0;
    }
    merge_queue(s_rv, s_ri, k, s_cv, s_ci, R, s_mv, s_mi);

    // ---- phase logic ----
    if (st.p1neg) {  // push the kf nearest filtered descending new ones
      if (tid < R)
        s_cv[tid] = is_new && is_pass && vn < st.x_v ? vn : kInf;
      __syncthreads();
      top_small(s_cv, s_nid, R, kf, s_tv, s_ti);
      merge_queue(s_fv, s_fi, F, s_tv, s_ti, kf, s_mv, s_mi);
    }
    if (st.to2) {  // fall to phase 2: beam <- frontier + new neighbours
      for (int e = tid; e < F; e += nt) {
        s_cv[e] = s_fv[e];
        s_ci[e] = s_fi[e];
      }
      if (tid < R) {
        s_cv[F + tid] = is_new ? vn : kInf;
        s_ci[F + tid] = nid;
      }
      __syncthreads();
      merge_queue(s_bv, s_bi, B, s_cv, s_ci, F + R, s_mv, s_mi);
      for (int e = tid; e < F; e += nt) {
        s_fv[e] = kInf;
        s_fi[e] = -1;
      }
    }
    if (st.in2) {  // beam-merge the new ones; maybe re-enter phase 1
      if (tid < R) s_cv[tid] = is_new ? vn : kInf;
      __syncthreads();
      merge_queue(s_bv, s_bi, B, s_cv, s_ci, R, s_mv, s_mi);
      if (st.reenter) {
        if (tid < R) s_cv[tid] = is_new && is_pass ? vn : kInf;
        __syncthreads();
        top_small(s_cv, s_nid, R, kf, s_tv, s_ti);
        if (s_tv[0] < kHalfInf) {  // has a candidate: uniform
          for (int e = tid; e < F; e += nt) {
            s_fv[e] = kInf;
            s_fi[e] = -1;
          }
          __syncthreads();
          merge_queue(s_fv, s_fi, F, s_tv, s_ti, kf, s_mv, s_mi);
          for (int e = tid; e < B; e += nt) {
            s_bv[e] = kInf;
            s_bi[e] = -1;
          }
          if (tid == 0) st.phase = 1;
        }
      }
    }
    if (tid == 0) {
      if (st.to2) st.phase = 2;
      st.hops += 1;
      st.p1_hops += st.uf;
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += nt) {
    res_v[(size_t)q * k + i] = s_rv[i];
    res_i[(size_t)q * k + i] = s_ri[i];
  }
  if (tid == 0) {
    term_out[q] = st.term == kRunning ? kMaxHop : st.term;
    hops_out[q] = st.hops;
    p1_out[q] = st.p1_hops;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vectors (n, d) f32; adjacency (n, R) i32 (-1 pad); pass_bm (Q, W) i32
// words; q_vecs (Q, d) f32; seeds (Q, S) i32 (-1 pad); res0_v (Q, k) f32
// and res0_i (Q, k) i32, the results carried into the round. Outputs:
// res_v (Q, k) f32, res_i (Q, k) i32, term, hops, p1_hops (Q) i32, visited
// (Q, W) i32 words (W = ceil(n/32); the kernel writes every word). R, S <=
// 256; k, B, F <= 64; 1 <= kf <= R; gw (1..8) gather warps and smem_bytes
// >= (1 + 2 * gw) * ceil4(d) * 4 of dynamic shared memory (the wrapper's
// walk_round_plan). vec4 != 0 promises d % 4 == 0 and 16-byte aligned
// q_vecs/vectors. Returns cudaGetLastError().
extern "C" int walk_round_launch(
    const void* vectors, const void* adjacency, const void* pass_bm,
    const void* q_vecs, const void* seeds, const void* res0_v,
    const void* res0_i, int Q, int d, int R, int W, int S, int k, int B,
    int F, int kf, int stall_budget, int max_hops, int vec4, int gw,
    int smem_bytes, void* res_v, void* res_i, void* term, void* hops,
    void* p1_hops, void* visited, void* stream) {
  if (Q == 0) return 0;
  const long long need = (1LL + kSlots * gw) * ((d + 3) / 4) * 16;
  if (R < 1 || R > kMaxR || S < 0 || S > kThreads || k < 1 ||
      k > kMaxQueue || B < 1 || B > kMaxQueue || F < 1 || F > kMaxQueue ||
      kf < 1 || kf > R || gw < 1 || gw > kThreads / 32 || smem_bytes < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  walk_round_kernel<<<Q, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vectors), static_cast<const int*>(adjacency),
      static_cast<const unsigned*>(pass_bm),
      static_cast<const float*>(q_vecs), static_cast<const int*>(seeds),
      static_cast<const float*>(res0_v), static_cast<const int*>(res0_i), d,
      R, W, S, k, B, F, kf, stall_budget, max_hops, vec4, gw,
      static_cast<float*>(res_v), static_cast<int*>(res_i),
      static_cast<int*>(term), static_cast<int*>(hops),
      static_cast<int*>(p1_hops), static_cast<unsigned*>(visited));
  return static_cast<int>(cudaGetLastError());
}
