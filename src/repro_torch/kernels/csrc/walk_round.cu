// walk_round: one restart round of the batched drift-guided walk, every
// query lane walked to its own end in one launch.
//
// Replaces the reference's walk ``lax.while_loop`` around the Pallas K2
// kernel (src/repro/core/batched/engine.py:157-262, walk_batch, whose hops
// call fiber_expand_walk, src/repro/kernels/fiber_expand.py:79). Its plain
// version is the port's walk_batch (core/batched/engine.py), which runs the
// lanes in lockstep with PyTorch ops and reads "is any lane running" on the
// host. Lanes never exchange data: the lockstep only batches them, and a
// lane's outputs stop changing once it terminates. So here a lane runs its
// hops to its own end or max_hops, with walk_batch's termination order
// (converged, early, stall, max-hop), and no host read happens inside the
// round.
//
// What bounds it on the H100: a hop is a chain of dependent steps (pop,
// adjacency row, visited and pass words, the rows, the merges), and the
// rows it reads (a d-float corpus row for each neighbour that is new or
// passes, the only ones whose distance any output depends on) come from
// data-dependent addresses at 2 flops per 4 bytes. The design:
//
// * Hop control in one warp. Warp 0 of a lane's leader block owns the
//   frontier (F), beam (B) and result (k) queues in shared memory, the pop
//   (a head offset), the termination test, the expansion and the phase
//   logic; the block's other warps only dot rows. The warps meet at named
//   barriers (kBarList, kBarDots), never at __syncthreads.
// * Threshold-pruned merges. A candidate enters a cap-queue only if its
//   value is below the queue's last entry (an equal one never does: queue
//   entries come first among equals). Survivors of a 32-candidate chunk are
//   found with one ballot; a survivor's place is the count of queue entries
//   at or below it (a binary search: the queue is sorted) plus the
//   survivors before it in (value, index) order, and a queue entry moves
//   down by the survivors below it. Chunks merge in index order, so the
//   result is walk_batch's stable sort's: queue entries first among equal
//   values, then candidates in index order. A top-k is the same merge into
//   a queue of sentinels, ties to the lower index.
// * A row ring fed by Hopper bulk copies. One thread of each block issues
//   every row the block dots as one cp.async.bulk of d*4 bytes into a ring
//   of row buffers, each with a full and an empty mbarrier and one owning
//   gather warp, which dots its buffer once the full barrier flips (K2's
//   warp_dot, so every dot is the float K2 gives) and releases it. Where
//   d % 4 != 0 or an input is not 16-byte aligned (vec4 == 0) each gather
//   warp copies its own rows with 4-byte cp.async instead.
// * A launch shaped by Q (the wrapper's walk_round_plan). A block takes at
//   most half an SM's shared memory, so two fit an SM. With Q >= the SM
//   count the grid is persistent: each block (a cluster of 1) takes its
//   next lane from a device counter, so lanes that walk long do not leave
//   SMs idle. With fewer lanes than SMs a lane gets a thread block cluster
//   of C blocks: the leader keeps the queues, every block of the cluster
//   bulk-copies and dots its share of the hop's rows (row j to block j % C)
//   and writes the dots into the leader's shared memory (distributed
//   shared memory), with two cluster barriers a hop.
//
// The lane's pass and visited bitmaps live in the leader's shared memory
// where the plan has room for them (the pass words staged and the visited
// ones zeroed as the lane starts, the visited ones copied out to its row of
// the (Q, ceil(n/32)) output as it ends), else in global memory (visited
// written with atomicOr and read through L2), so any n works. The
// in-results test is against the round's k carried result ids, which are
// fixed for the round. The popped node's own distance vx is the value
// it was queued with, which the same dot gave, so its row is not read
// again. The drift's sum keeps one order: a neighbour slot a lane, a
// butterfly within each 32-slot chunk, the chunk sums in chunk order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gather_dot.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGatherWarps = kThreads / 32 - 1;  // warps 1..7 dot rows
constexpr int kMaxR = 256;                       // neighbour slots, seeds
constexpr int kChunks = kMaxR / 32;
constexpr int kMaxQueue = 64;                    // k, B, F caps
constexpr int kMaxSlots = 32;                    // ring row buffers
constexpr int kMaxCluster = 8;
constexpr float kInf = 3.4e38f;  // the engine's INF sentinel in float32
constexpr float kHalfInf = 1.7e38f;
constexpr unsigned kFull = 0xffffffffu;
enum { kBarList = 1, kBarDots = 2, kBarStage = 3 };

enum { kRunning = 0, kConverged = 1, kEarly = 2, kStall = 3, kMaxHop = 4 };
enum { kValid = 1, kNew = 2, kPass = 4, kInRes = 8 };

struct Args {
  const float* vectors;
  const int* adjacency;
  const unsigned* pass_bm;
  const float* q_vecs;
  const int* seeds;
  const float* res0_v;
  const int* res0_i;
  int Q, d, R, W, S, k, B, F, kf, stall_budget, max_hops, vec4;
  int slots, ge;  // ring buffers and gather warps (slots % ge == 0)
  int cluster;    // blocks a lane (1: a plain launch)
  int bm_smem;    // the pass and visited bitmaps in shared memory
  float* res_v;
  int* res_i;
  int* term;
  int* hops;
  int* p1_hops;
  unsigned* visited;
  int* counter;
};

// What the leader's control warp sends every block of the lane's cluster
// before each gather: the lane (Q or more: no lanes left) and the block's
// share of the rows to dot (row j of the hop is block j % C's j / C-th).
struct Msg {
  int q, n;
  int rows[kMaxR];
};

// A sorted queue of cap entries in shared memory, popped by a head offset:
// logical entry j is buf[head + j], the sentinel (kInf, -1) past the end.
// Only warp 0 touches it; head is a register equal in all its lanes.
struct Queue {
  float* v;
  int* i;
  int cap, head;
  __device__ float val(int j) const {
    j += head;
    return j < cap ? v[j] : kInf;
  }
  __device__ int id(int j) const {
    j += head;
    return j < cap ? i[j] : -1;
  }
  __device__ void clear(int lane) {
    for (int j = lane; j < cap; j += 32) {
      v[j] = kInf;
      i[j] = -1;
    }
    head = 0;
    __syncwarp();
  }
};

// Merge one chunk of up to 32 candidates (lane t holds (cv, ci), ``ok``
// where it holds one) into q, keeping the cap smallest: queue entries
// first among equal values, then candidates in lane order. ov/oi are
// cap-sized scratch. Warp 0 calls it.
__device__ void merge_chunk(Queue& q, float cv, int ci, bool ok, float* ov,
                            int* oi, int lane) {
  const float thr = q.val(q.cap - 1);
  const bool surv = ok && cv < thr;
  const unsigned m = __ballot_sync(kFull, surv);
  if (m == 0u) return;
  const int j0 = lane, j1 = lane + 32;
  const float q0 = q.val(j0), q1 = q.val(j1);
  int rank = 0, below0 = 0, below1 = 0;
  for (unsigned mm = m; mm; mm &= mm - 1) {
    const int t = __ffs(mm) - 1;
    const float vt = __shfl_sync(kFull, cv, t);
    rank += (vt < cv) || (vt == cv && t < lane);
    below0 += vt < q0;
    below1 += vt < q1;
  }
  if (surv) {
    int lo = 0, hi = q.cap;  // queue entries at or below cv
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (q.val(mid) <= cv)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int place = lo + rank;
    if (place < q.cap) {
      ov[place] = cv;
      oi[place] = ci;
    }
  }
  if (j0 < q.cap && j0 + below0 < q.cap) {
    ov[j0 + below0] = q0;
    oi[j0 + below0] = q.id(j0);
  }
  if (j1 < q.cap && j1 + below1 < q.cap) {
    ov[j1 + below1] = q1;
    oi[j1 + below1] = q.id(j1);
  }
  __syncwarp();
  for (int j = lane; j < q.cap; j += 32) {
    q.v[j] = ov[j];
    q.i[j] = oi[j];
  }
  q.head = 0;
  __syncwarp();
}

__device__ __forceinline__ bool bit(unsigned w, int i) {
  return (w >> (i & 31)) & 1u;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

struct Shared {
  float fv[kMaxQueue], bv[kMaxQueue], rv[kMaxQueue], ov[kMaxQueue],
      tv[kMaxQueue];
  int fi[kMaxQueue], bi[kMaxQueue], ri[kMaxQueue], oi[kMaxQueue],
      ti[kMaxQueue], r0i[kMaxQueue];
  float dot[kMaxR];
  Msg msg;
  uint64_t full[kMaxSlots], empty[kMaxSlots];
};

// Everything a block needs besides Args: its shared memory, its place in
// the cluster and its ring's running row count.
struct Ctx {
  Shared* sh;
  float* s_q;    // the lane's query, ceil4(d) floats
  float* ring;   // row buffers of ceil4(d) floats
  unsigned* s_pass;  // W words each after the ring, with bm_smem
  unsigned* s_vis;
  int dp, C, rank, lane, warp;
  // The ring: the block's s-th row goes to buffer s % slots and to gather
  // warp s % ge, which owns that buffer (slots % ge == 0): each buffer's
  // uses are read by one warp in order, so no full or empty barrier is
  // waited on more than one phase ahead (its parity would name the wrong
  // phase).
  int ge, slots;
  unsigned seq;  // rows this block has put through its ring
};

// Gather barrier "the message is out" (A) and "the dots are in" (B). With
// C == 1 the control warp arrives at A and waits at B, the gather warps the
// other way round; a cluster meets at its hardware barrier both times.
__device__ __forceinline__ void meet(int C, int id, bool wait) {
  if (C > 1)
    cg::this_cluster().sync();
  else if (wait)
    ptx::bar_sync(id, kThreads);
  else
    ptx::bar_arrive(id, kThreads);
}

// Warp 0's producer side (lane 0 issues): the block's n rows of this
// message, each a bulk copy into the next ring slot once its last reader
// released it.
__device__ void produce(const Args& a, Ctx& c, int n) {
  if (a.vec4 && c.lane == 0) {
    const unsigned bytes = (unsigned)a.d * 4u;
    for (int j = 0; j < n; ++j) {
      const unsigned s = c.seq + j;
      const int slot = s % c.slots;
      if (s >= (unsigned)c.slots)
        ptx::mbar_wait(&c.sh->empty[slot], ((s / c.slots) - 1) & 1);
      ptx::mbar_expect_tx(&c.sh->full[slot], bytes);
      ptx::bulk_copy(c.ring + (size_t)slot * c.dp,
                     a.vectors + (size_t)c.sh->msg.rows[j] * a.d, bytes,
                     &c.sh->full[slot]);
    }
  }
  __syncwarp();
  c.seq += n;
}

// A gather warp's side: its rows of this message (the block's rows s with
// s % ge its own), each dot written to the leader's dot[j] for the hop's
// row j.
__device__ void consume(const Args& a, Ctx& c, int n, float* lead_dot) {
  const int w = c.warp - 1;
  if (w < c.ge) {
    for (int j = (w - (int)(c.seq % c.ge) + c.ge) % c.ge; j < n; j += c.ge) {
      const unsigned s = c.seq + j;
      float* row;
      if (a.vec4) {
        const int slot = s % c.slots;
        row = c.ring + (size_t)slot * c.dp;
        ptx::mbar_wait(&c.sh->full[slot], (s / c.slots) & 1);
      } else {  // the warp's own buffer, filled by 4-byte cp.async
        row = c.ring + (size_t)w * c.dp;
        gather::copy_vec(row, a.vectors + (size_t)c.sh->msg.rows[j] * a.d,
                         a.d, 0, c.lane, 32);
        ptx::commit();
        ptx::wait_group<0>();
        __syncwarp();
      }
      const float acc = gather::warp_dot(row, c.s_q, a.d, a.vec4, c.lane);
      if (c.lane == 0) lead_dot[j * c.C + c.rank] = acc;
      __syncwarp();  // every lane is done with the buffer
      if (a.vec4 && c.lane == 0)
        ptx::mbar_arrive(&c.sh->empty[(int)(s % c.slots)]);
    }
  }
  c.seq += n;
}

// Every warp but the leader's control warp: wait for a message, stage a new
// lane's query (and, in the leader, its pass words and zeroed visited
// ones), take part in the gather, report the dots; until the message says
// no lanes are left.
__device__ void worker(const Args& a, Ctx& c) {
  float* lead_dot = c.sh->dot;
  if (c.C > 1) lead_dot = cg::this_cluster().map_shared_rank(c.sh->dot, 0);
  int cur = -1;
  for (;;) {
    meet(c.C, kBarList, true);
    const int q = c.sh->msg.q, n = c.sh->msg.n;
    if (q >= a.Q) break;
    if (c.warp > 0 && q != cur) {
      const int t = threadIdx.x - 32, nt = kThreads - 32;
      gather::copy_vec(c.s_q, a.q_vecs + (size_t)q * a.d, a.d, a.vec4, t, nt);
      ptx::commit();
      if (c.rank == 0 && a.bm_smem) {
        const unsigned* pass = a.pass_bm + (size_t)q * a.W;
        for (int w = t; w < a.W; w += nt) {
          c.s_pass[w] = __ldg(pass + w);
          c.s_vis[w] = 0u;
        }
      } else if (c.rank == 0) {
        for (int w = t; w < a.W; w += nt)
          __stcg(a.visited + (size_t)q * a.W + w, 0u);
      }
      ptx::wait_group<0>();
      ptx::bar_sync(kBarStage, nt);
    }
    cur = q;
    if (c.warp == 0)
      produce(a, c, n);
    else
      consume(a, c, n, lead_dot);
    meet(c.C, kBarDots, false);
  }
}

// The control warp's messages: row j of the hop goes to block j % C (every
// lane that ``has`` one places it), then ``post`` sends the lane and each
// block's row count.
__device__ __forceinline__ Msg* msg_of(const Ctx& c, int b) {
  return c.C > 1 ? cg::this_cluster().map_shared_rank(&c.sh->msg, b)
                 : &c.sh->msg;
}

__device__ __forceinline__ void place(const Ctx& c, int j, int row,
                                      bool has) {
  if (has) msg_of(c, j % c.C)->rows[j / c.C] = row;
}

__device__ __forceinline__ void post(const Ctx& c, int q, int n) {
  if (c.lane < c.C) {
    Msg* m = msg_of(c, c.lane);
    m->q = q;
    m->n = (n - c.lane + c.C - 1) / c.C;
  }
}

// One gather round trip from the control warp: the message is out (rows
// already placed), its own block's rows produced, the dots in.
__device__ void gather_rows(const Args& a, Ctx& c) {
  __syncwarp();
  meet(c.C, kBarList, false);
  produce(a, c, c.sh->msg.n);
  meet(c.C, kBarDots, true);
}

// The lane's pass and visited words as the control warp reads and marks
// them: in shared memory, or its rows in global memory (the visited ones
// through L2, where its atomicOr lands).
struct Bits {
  const unsigned* pass;
  unsigned* vis;
  bool smem;
  __device__ bool passes(int id) const {
    return bit(smem ? pass[id >> 5] : __ldg(pass + (id >> 5)), id);
  }
  __device__ bool seen(int id) const {
    return bit(smem ? vis[id >> 5] : __ldcg(vis + (id >> 5)), id);
  }
  __device__ void mark(int id) const {
    atomicOr(vis + (id >> 5), 1u << (id & 31));
  }
};

__device__ void control(const Args& a, Ctx& c) {
  Shared& s = *c.sh;
  const int lane = c.lane;
  const int R = a.R, k = a.k;
  const int nch = (R + 31) / 32;
  const int kc = min(a.kf, a.F);  // pushes that can reach the frontier
  Queue fq{s.fv, s.fi, a.F, 0}, bq{s.bv, s.bi, a.B, 0}, rq{s.rv, s.ri, k, 0};
  Queue tq{s.tv, s.ti, kc, 0};

  int q = 0;
  if (lane == 0) q = atomicAdd(a.counter, 1);
  q = __shfl_sync(kFull, q, 0);
  while (q < a.Q) {
    unsigned* vis_row = a.visited + (size_t)q * a.W;
    const Bits bits = a.bm_smem
        ? Bits{c.s_pass, c.s_vis, true}
        : Bits{a.pass_bm + (size_t)q * a.W, vis_row, false};
    fq.clear(lane);
    bq.clear(lane);
    for (int i = lane; i < k; i += 32) {
      s.rv[i] = a.res0_v[(size_t)q * k + i];
      s.ri[i] = s.r0i[i] = a.res0_i[(size_t)q * k + i];
    }
    rq.head = 0;
    __syncwarp();

    // ---- seeds: distances, visited bits, the frontier and the results ----
    const int nsch = (a.S + 31) / 32;
    int sid[kChunks], srow[kChunks];
    int n_rows = 0;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int e = ch * 32 + lane;
      sid[ch] = (ch < nsch && e < a.S) ? a.seeds[(size_t)q * a.S + e] : -1;
      const bool has = sid[ch] >= 0;
      const unsigned m = __ballot_sync(kFull, has);
      srow[ch] = has ? n_rows + __popc(m & lanes_below(lane)) : -1;
      place(c, srow[ch], sid[ch], has);
      n_rows += __popc(m);
    }
    post(c, q, n_rows);
    gather_rows(a, c);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      if (ch >= nsch) break;
      const int e = ch * 32 + lane;
      const int id = sid[ch];
      const float v = id >= 0 ? 1.0f - s.dot[srow[ch]] : kInf;
      bool in_res = false;
      for (int j = 0; j < k; ++j) in_res |= id >= 0 && s.r0i[j] == id;
      const bool pass = id >= 0 && bits.passes(id) && !in_res;
      if (id >= 0) bits.mark(id);
      merge_chunk(fq, v, id, e < a.S, s.ov, s.oi, lane);
      merge_chunk(rq, pass ? v : kInf, id, e < a.S, s.ov, s.oi, lane);
    }

    int phase = 1, stall = 0, term = kRunning, hops = 0, p1_hops = 0;
    for (int t = 0; t < a.max_hops; ++t) {
      // ---- pop one node; termination (phase-2 semantics) ----
      const bool f_empty = fq.val(0) >= kHalfInf;
      const bool b_empty = bq.val(0) >= kHalfInf;
      if (phase == 1 && f_empty) phase = 2;
      const bool uf = phase == 1;
      Queue& pq = uf ? fq : bq;
      const float x_v = pq.val(0);
      const int x_id = pq.id(0);
      pq.head = min(pq.head + 1, pq.cap);
      const float v_k = s.rv[k - 1];
      const bool nothing = uf ? (f_empty && b_empty) : b_empty;
      const bool early = !uf && x_v > v_k && v_k < kHalfInf;
      const bool stallout = !uf && stall >= a.stall_budget;
      term = nothing ? kConverged
                     : early ? kEarly : stallout ? kStall : kRunning;
      if (term != kRunning) break;

      // ---- expand x: neighbour flags, visited bits, the rows to dot ----
      const int* arow = a.adjacency + (size_t)max(x_id, 0) * R;
      int nid[kChunks], fl[kChunks], row[kChunks];
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int r = ch * 32 + lane;
        nid[ch] = (ch < nch && r < R) ? __ldg(arow + r) : -1;
      }
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        fl[ch] = 0;
        const int id = nid[ch];
        if (id >= 0) {
          fl[ch] = kValid;
          if (!bits.seen(id)) fl[ch] |= kNew;
          if (bits.passes(id)) fl[ch] |= kPass;
        }
      }
      n_rows = 0;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        if (ch >= nch) break;
        const int id = nid[ch];
        if ((fl[ch] & (kNew | kPass)) == (kNew | kPass))
          for (int j = 0; j < k; ++j)
            if (s.r0i[j] == id) fl[ch] |= kInRes;
        const bool need = fl[ch] & (kNew | kPass);
        const unsigned m = __ballot_sync(kFull, need);
        row[ch] = need ? n_rows + __popc(m & lanes_below(lane)) : -1;
        place(c, row[ch], id, need);
        n_rows += __popc(m);
      }
      __syncwarp();  // every seen bit is read before any is set
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        if (fl[ch] & kNew) bits.mark(nid[ch]);
      post(c, q, n_rows);
      gather_rows(a, c);

      // ---- result candidates and the local signals ----
      float vn[kChunks];
      int n_pass = 0, new_filt = 0;
      float sum = 0.f;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        if (ch >= nch) break;
        vn[ch] = row[ch] >= 0 ? 1.0f - s.dot[row[ch]] : kInf;
        const bool is_new = fl[ch] & kNew, is_pass = fl[ch] & kPass;
        n_pass += __popc(__ballot_sync(kFull, is_pass));
        new_filt += __popc(__ballot_sync(kFull, is_new && is_pass));
        float c_sum = is_pass ? vn[ch] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
          c_sum += __shfl_xor_sync(kFull, c_sum, o);
        sum += c_sum;
        const bool res = is_new && is_pass && !(fl[ch] & kInRes);
        merge_chunk(rq, res ? vn[ch] : kInf, nid[ch], true, s.ov, s.oi,
                    lane);
      }
      const float drift =
          n_pass > 0 ? sum / (float)n_pass - x_v : INFINITY;
      const bool neg = drift < 0.f;
      stall = new_filt > 0 ? 0 : stall + 1;
      const bool p1neg = phase == 1 && neg;
      const bool to2 = phase == 1 && !neg;
      const bool in2 = phase == 2;
      const bool reenter = in2 && neg && new_filt > 0;

      // ---- phase logic ----
      if (p1neg) {  // push the kf nearest filtered descending new ones
        tq.clear(lane);
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (ch >= nch) break;
          const bool ok = (fl[ch] & (kNew | kPass)) == (kNew | kPass) &&
                          vn[ch] < x_v;
          merge_chunk(tq, ok ? vn[ch] : kInf, nid[ch], true, s.ov, s.oi,
                      lane);
        }
        for (int e = 0; e < kc; e += 32)
          merge_chunk(fq, tq.val(e + lane), tq.id(e + lane), e + lane < kc,
                      s.ov, s.oi, lane);
      }
      if (to2) {  // fall to phase 2: beam <- frontier + new neighbours
        for (int e = 0; e < a.F; e += 32)
          merge_chunk(bq, fq.val(e + lane), fq.id(e + lane), e + lane < a.F,
                      s.ov, s.oi, lane);
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (ch >= nch) break;
          merge_chunk(bq, (fl[ch] & kNew) ? vn[ch] : kInf, nid[ch], true,
                      s.ov, s.oi, lane);
        }
        fq.clear(lane);
        phase = 2;
      }
      if (in2) {  // beam-merge the new ones; maybe re-enter phase 1
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (ch >= nch) break;
          merge_chunk(bq, (fl[ch] & kNew) ? vn[ch] : kInf, nid[ch], true,
                      s.ov, s.oi, lane);
        }
        if (reenter) {
          tq.clear(lane);
#pragma unroll
          for (int ch = 0; ch < kChunks; ++ch) {
            if (ch >= nch) break;
            const bool ok = (fl[ch] & (kNew | kPass)) == (kNew | kPass);
            merge_chunk(tq, ok ? vn[ch] : kInf, nid[ch], true, s.ov, s.oi,
                        lane);
          }
          if (tq.val(0) < kHalfInf) {  // has a candidate
            fq.clear(lane);
            for (int e = 0; e < kc; e += 32)
              merge_chunk(fq, tq.val(e + lane), tq.id(e + lane),
                          e + lane < kc, s.ov, s.oi, lane);
            bq.clear(lane);
            phase = 1;
          }
        }
      }
      hops += 1;
      p1_hops += uf;
    }

    for (int i = lane; i < k; i += 32) {
      a.res_v[(size_t)q * k + i] = s.rv[i];
      a.res_i[(size_t)q * k + i] = s.ri[i];
    }
    if (a.bm_smem)
      for (int w = lane; w < a.W; w += 32) vis_row[w] = c.s_vis[w];
    if (lane == 0) {
      a.term[q] = term == kRunning ? kMaxHop : term;
      a.hops[q] = hops;
      a.p1_hops[q] = p1_hops;
      q = atomicAdd(a.counter, 1);
    }
    q = __shfl_sync(kFull, q, 0);
  }
  post(c, a.Q, 0);  // no lanes left
  __syncwarp();
  meet(c.C, kBarList, false);
}

// grid: clusters of C blocks (C = 1: a plain launch), blockDim kThreads;
// dynamic shared memory (1 + slots) * ceil4(d) floats, the query and the
// ring's row buffers, then with bm_smem the pass and visited words (W
// each).
__global__ void __launch_bounds__(kThreads, 2) walk_round_kernel(Args a) {
  extern __shared__ float4 s_dyn[];
  __shared__ Shared sh;
  Ctx c;
  c.sh = &sh;
  c.dp = (a.d + 3) & ~3;
  c.s_q = reinterpret_cast<float*>(s_dyn);
  c.ring = c.s_q + c.dp;
  c.s_pass = reinterpret_cast<unsigned*>(c.ring + (size_t)a.slots * c.dp);
  c.s_vis = c.s_pass + a.W;
  c.C = a.cluster;
  c.rank = c.C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  c.lane = threadIdx.x & 31;
  c.warp = threadIdx.x >> 5;
  c.seq = 0;
  c.ge = a.ge;
  c.slots = a.slots;
  if (threadIdx.x == 0) {
    for (int i = 0; i < c.slots; ++i) {
      ptx::mbar_init(&sh.full[i], 1);
      ptx::mbar_init(&sh.empty[i], 1);
    }
    ptx::fence_mbar_init();
  }
  __syncthreads();
  if (c.C > 1) cg::this_cluster().sync();
  if (c.rank == 0 && c.warp == 0)
    control(a, c);
  else
    worker(a, c);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The device's SM count and shared memory (a block's opt-in and an SM's),
// for the wrapper's walk_round_plan.
extern "C" int walk_round_device(int device, int* sms, int* smem_block,
                                 int* smem_sm) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  return static_cast<int>(e);
}

static cudaLaunchConfig_t launch_config(int grid, int cluster, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// What the device grants a plan of ``smem_bytes`` dynamic shared memory and
// clusters of ``cluster`` blocks: blocks an SM, clusters resident at once,
// and the kernel's static shared memory.
extern "C" int walk_round_occupancy(int smem_bytes, int cluster,
                                    int* blocks_per_sm, int* max_clusters,
                                    int* static_smem) {
  cudaError_t e = cudaFuncSetAttribute(
      walk_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, walk_round_kernel, kThreads, smem_bytes);
  cudaFuncAttributes attrs;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attrs, walk_round_kernel);
  if (e == cudaSuccess) *static_smem = (int)attrs.sharedSizeBytes;
  *max_clusters = 0;
  if (e == cudaSuccess && cluster > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(cluster, cluster, smem_bytes, 0, &attr);
    e = cudaOccupancyMaxActiveClusters(max_clusters, walk_round_kernel, &cfg);
  }
  return static_cast<int>(e);
}

// vectors (n, d) f32; adjacency (n, R) i32 (-1 pad); pass_bm (Q, W) i32
// words; q_vecs (Q, d) f32; seeds (Q, S) i32 (-1 pad); res0_v (Q, k) f32
// and res0_i (Q, k) i32, the results carried into the round. Outputs:
// res_v (Q, k) f32, res_i (Q, k) i32, term, hops, p1_hops (Q) i32, visited
// (Q, W) i32 words (W = ceil(n/32); the kernel writes every word). counter:
// one zeroed int, the lanes handed out. R, S <= 256; k, B, F <= 64; 1 <= kf
// <= R. The plan (the wrapper's walk_round_plan): ``slots`` (1..32) ring
// row buffers, a multiple of ``gather_warps`` (1..7), in smem_bytes >= (1
// + slots) * ceil4(d) * 4 (+ 8 * W with ``bitmaps``, the pass and visited
// words in shared memory) of dynamic shared memory, ``grid`` blocks in
// clusters of ``cluster`` (1..8; grid a multiple of it). vec4 != 0
// promises d % 4 == 0 and 16-byte aligned q_vecs/vectors. Returns
// cudaGetLastError().
extern "C" int walk_round_launch(
    const void* vectors, const void* adjacency, const void* pass_bm,
    const void* q_vecs, const void* seeds, const void* res0_v,
    const void* res0_i, int Q, int d, int R, int W, int S, int k, int B,
    int F, int kf, int stall_budget, int max_hops, int vec4, int slots,
    int gather_warps, int bitmaps, int smem_bytes, int grid, int cluster,
    void* res_v, void* res_i, void* term, void* hops, void* p1_hops,
    void* visited, void* counter, void* stream) {
  if (Q == 0) return 0;
  const long long need =
      (1LL + slots) * ((d + 3) / 4) * 16 + (bitmaps ? 8LL * W : 0LL);
  if (R < 1 || R > kMaxR || S < 0 || S > kMaxR || k < 1 || k > kMaxQueue ||
      B < 1 || B > kMaxQueue || F < 1 || F > kMaxQueue || kf < 1 || kf > R ||
      slots < 1 || slots > kMaxSlots || gather_warps < 1 ||
      gather_warps > kGatherWarps || slots % gather_warps != 0 ||
      cluster < 1 || cluster > kMaxCluster || grid < cluster ||
      grid % cluster != 0 ||
      smem_bytes < need || (vec4 && d % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      walk_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.vectors = static_cast<const float*>(vectors);
  a.adjacency = static_cast<const int*>(adjacency);
  a.pass_bm = static_cast<const unsigned*>(pass_bm);
  a.q_vecs = static_cast<const float*>(q_vecs);
  a.seeds = static_cast<const int*>(seeds);
  a.res0_v = static_cast<const float*>(res0_v);
  a.res0_i = static_cast<const int*>(res0_i);
  a.Q = Q;
  a.d = d;
  a.R = R;
  a.W = W;
  a.S = S;
  a.k = k;
  a.B = B;
  a.F = F;
  a.kf = kf;
  a.stall_budget = stall_budget;
  a.max_hops = max_hops;
  a.vec4 = vec4;
  a.slots = slots;
  a.ge = gather_warps;
  a.cluster = cluster;
  a.bm_smem = bitmaps != 0;
  a.res_v = static_cast<float*>(res_v);
  a.res_i = static_cast<int*>(res_i);
  a.term = static_cast<int*>(term);
  a.hops = static_cast<int*>(hops);
  a.p1_hops = static_cast<int*>(p1_hops);
  a.visited = static_cast<unsigned*>(visited);
  a.counter = static_cast<int*>(counter);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      grid, cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, walk_round_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
