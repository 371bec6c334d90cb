#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(logging what ``-Xptxas -v`` printed for each), builds a paper-size index
on the host (H&M scale: 105,100 x 2048, 24 categorical fields plus two OR
fields and a timestamp field; 1,344 more rows of the same corpus are held
out for ingest), holds each of the six kernels against its plain PyTorch
version on the card at the shapes its path gives it (K2 at Q=64 and at
Q=256; K3 on one-cluster masks at k=10 and on a random half mask at k=32;
WR, the walk round ``walk_round``, against ``walk_batch`` on the first
restart round of the conjunctive Q=64 and Q=256, OR and range batches,
seeded as the search seeds them, and on the conjunctive Q=64 batch's
second round: a mean per-lane id overlap of at least 0.98, its exact
share logged) and also at ragged shapes (K1 in its three forms across its
tile and query-group edges; K4 across its words and grid, at odd and even
F, v_cap 32 to 1024 and with every clause inactive; K2, K3 and K5 at
n % 32 != 0 and d % 4 != 0; K5 with no valid id, no pass bit and every
pass bit), and then drives fourteen paths, each with the launch counts
cleared just before it and read just after (the mesh path in segments
inside two others, the LM mesh path's retrieval inside the rag path,
the family mesh path inside the lm_families and training paths, the
family training mesh path inside the training path). A search is K1,
then per restart round K3 (seeds) and WR; every ``dispatch`` of an
engine on the card runs under ``torch.cuda.set_sync_debug_mode("error")``
(a host sync inside it raises) and every ``collect`` must report one
sync (``SyncChecked``):

* the kernel/plain-version parity gate (``kernels.parity.parity_gate``),
  the path of K2 ``fiber_expand_walk``, K4 ``filter_eval`` and K5
  ``fiber_expand``;
* the fused filtered search (``BatchedEngine(device="cuda").search``) on
  conjunctive, OR and range batches: every id passes its predicate, no
  duplicates, at most k per query, the stream still busy when the
  conjunctive Q=64 batch's ``dispatch`` returns behind ~0.2 s of queued
  device work (whether it is without that is logged), and the card's
  answers agree with the host engine's on the same batches;
* the live index: a capacity-slab engine over the same index ingests the
  held-out rows in batches of 64, 256 and 1,024 with deferred repair, the
  maintenance loop drains the backlog, a batch of rows is deleted, and
  every inserted row must be findable, no deleted or unwritten row may
  come back, and the post-churn ids must agree with the same state
  searched on the host;
* the sharded engine in reference mode (``ShardedEngine(device="cuda")``,
  four row shards of the same corpus on the one card, capacity for the
  held-out rows): the conjunctive Q=64, OR and range batches, checked as
  above and against the same index searched on the host, then 256
  held-out rows ingested and 128 rows deleted (every inserted survivor
  findable, no deleted row returned), then the port's two sharded smokes
  (``insert._smoke``, ``lifecycle._smoke``) on the card;
* the serving path (``RetrievalService(device="cuda")`` over the same
  index, capacity for the held-out rows): ``query_batch`` on the
  conjunctive Q=64, OR and range batches (held to the main path's ids),
  on 37 queries and on one (padded to their buckets), the Q=64 batch one
  query at a time through ``ServePipeline`` (held to ``query_batch``), the
  conjunctive Q=256 batch in batches of 16 through the pipeline and one
  ``query_batch`` after another (ms per query each way, in turns), the
  pipeline's ``_smoke`` and 16 sequential queries on the host (``query``,
  the stall regimes by selectivity); then a durable service ingests 256
  held-out rows in journaled batches of 64, deletes 128 rows, snapshots,
  ingests 64 more into the journal only, and ``RetrievalService.recover``
  brings it back (equal staleness, the live service's ids, every
  surviving inserted row findable, no deleted row returned), after which
  the parity gate runs on the card;
* the search and serving over a device mesh (``mesh``, in segments
  inside the sharded and serving paths, on their index and snapshot):
  the sharded path's index on a 1D mesh of four cells and on a 4 x 2
  data x query mesh, every cell on the one card (``devices=[cuda:0] *
  n``), the conjunctive Q=64, OR and range batches with each first call
  of K1, K3 and WR held to its plain version on a cell, ids, walks and
  hops equal to reference mode's, one dispatch a batch, the conjunctive
  batch timed beside reference mode in turns; and the serving path's
  durable snapshot recovered onto a two-cell mesh
  (``RetrievalService.recover(mesh=)``: an empty slab padded on, the
  journal replayed into it), its ``query_batch`` equal to reference
  mode's on the same recovered state and its recall@10 within 0.02 of
  the meshless recovery's;
* the LM retrieval bridge (``rag_path``): SmolLM-135M at full width (30
  layers, d 576, 9 heads / 3 KV, vocab 49,152; random weights from a
  seed) encodes 65,536 documents of 64 tokens on the card, 6 categorical
  fields of 8 codes are attached and the index is built on the host and
  served by ``RetrievalService(device="cuda")``;
  ``EncodedRetriever.retrieve_batch`` answers 64 prompts, one conjunctive
  predicate each (selectivities about 0.25 / 0.05 / 0.01), through
  K1/K3/WR at d = 576 (its first calls held to their plain versions and
  WR, K2 and K3 timed on them), with the ids of ``query_batch`` on
  ``embed_tokens``, every id passing its predicate, and recall against
  exact filtered top-k; ``retrieve`` answers 8 prompts on the host; 256 card embeddings
  are held to the port's on the host with the same weights (cosine);
  ``ServeEngine.generate`` decodes 16 tokens greedily for 4 prompts of
  32, the same tokens in two calls, the first the card prefill's argmax;
* the LM's serving over a device mesh (``lm_mesh``), every cell on the
  card: the rag path's 64 prompts encoded by SmolLM-135M on a 1 x 3 mesh
  (its 9 / 3 heads, d_ff and padded vocab split three ways) through
  ``EncodedRetriever.retrieve_batch`` (K1/K3/WR) for the same service, its
  bf16 embeddings at cosine >= 0.999 to the meshless encoder's and, both
  encoders in fp32, its ids overlapping the meshless retriever's by at
  least 0.98; llama3.2-1b at its
  published widths (16 layers, d 2,048, 32 / 8 heads, d_ff 8,192, vocab
  128,256) on a 2 x 4 data x model mesh, policy tp: placing its
  parameters costs at most 1.1x their memory (views of them), its
  prefill of 8 x 512 tokens held to the meshless prefill on the same
  parameters in bf16 and fp32, ``ServeEngine.generate`` of 32 greedy
  tokens whose every token the meshless model, fed them, scores within
  the bf16 tolerance of its best, ms a prefill, tokens/s and kernels a
  decode step beside the meshless run's; dbrx-132b at its published
  widths with 2 of 40 layers on a 1 x 4 mesh (4 experts a cell): a
  prefill of 4 x 256 through the expert-parallel capacity path (the
  dropped choices logged) and 4 decode steps through the dropless one,
  then at one layer the card mesh's prefill and decode held to the same
  mesh of host cells on the rows whose experts agree, in fp32 and bf16;
  ``flash_decode_sharded`` at llama's attention widths over a
  32,768-slot cache split over a 1 x 8 mesh, within 1e-4 of
  ``decode_attention`` in fp32;
* the moe, hybrid and ssm LM families (``lm_families_path``), one at a
  time with random weights from a seed: dbrx-132b at its published
  widths with 4 of its 40 layers (d 6,144, 48 / 8 heads, 16 experts top
  4, vocab 100,352; 57 GB of fp32 masters), hymba-1.5b and rwkv6-3b
  whole. Each prefills 4 prompts of 32 tokens (finite logits), generates
  16 tokens greedily (the same in two calls, the first the prefill's
  argmax), holds 4 decode steps to its prefill over the longer sequence
  in bf16 and in fp32 (dbrx at a dropless capacity factor), and holds
  its card prefill of one 16-token prompt to the port's on the host with
  the same weights in fp32 (dbrx at one layer; bf16 and its routing
  agreement logged). Hymba then encodes 16,384 documents of 64 tokens on
  the card, served by ``RetrievalService(device="cuda")``, and
  ``EncodedRetriever.retrieve_batch`` answers 64 prompts through K1, K3
  and walk_round at d = 1,600 (first calls held to their plain versions,
  walk_round, K2 and K3 timed),
  with the ids of ``query_batch`` on ``embed_tokens``, every id passing
  its predicate, recall against exact filtered top-k;
* the hybrid, ssm and audio families over a device mesh
  (``family_mesh``, segments inside the lm_families and training paths
  on their weights, the first layers as views), every cell on the card,
  policy tp: hymba-1.5b's first 2 layers on 2 x 4 (its 25 / 5 heads
  replicated, FFN and mamba channels split; 8 x 128 tokens, 16 new) and
  first layer on 1 x 5 (heads and KV heads split; one prompt of 1,088
  tokens wraps its 1,024-slot ring in prefill, 8 new), rwkv6-3b's first
  2 on 2 x 4 (10 heads a cell; 8 x 64, 16 new) and whisper-small's
  first 4 + 4 layers on 2 x 4 (4 x 1,500 frames, 16 decode steps; its
  12 heads, 3 a cell): placing costs at most
  1.1x the parameters' memory, the prefill is held to the meshless one
  on the same weights in bf16 and fp32, every fp32 decode step to the
  meshless step, ms a prefill, tokens/s and kernels a decode step beside
  the meshless run's; then hymba's 64 retrieval prompts encoded whole on
  2 x 4 through ``EncodedRetriever.retrieve_batch`` (K1/K3/WR) for the
  lm_families service, its fp32 ids overlapping the meshless
  retriever's by at least 0.98;
* training (``train_path``; it launches none of the six kernels):
  SmolLM-135M whole as ``launch/train.py --full`` trains it (batch 8 x
  128 tokens, lr 3e-3): step 0's loss and gradients on the card held to
  the host's from the same weights and batch in fp32 and bf16, 30 steps
  of ``TrainLoop`` (the loss descending; ms a step, tokens/s, peak
  memory), a checkpoint after 6 steps resumed to 12 (the losses of the
  straight run), and SIGUSR1 during step 3 (a checkpoint of step 4, the
  run ended); whisper-small whole: its encoder over 1,500 frames and 16
  greedy decode steps for 4 prompts of 32 tokens, held to ``prefill``
  over the longer sequence and to the host's prefill in bf16 and fp32,
  then 10 training steps on frame batches; one fp32 ``make_train_step``
  of hymba-1.5b and of rwkv6-3b at full width and 2 layers held to the
  host's; dbrx-132b at full width and 1 layer, the loss and gradients
  through the MoE's capacity path (finite, none zero) and its bf16
  token losses held to fp32 on the tokens whose experts agree;
* the hybrid, ssm and audio families trained over a device mesh
  (``family_train_mesh``, segments inside the training path on its
  weights; it launches none of the six kernels), every cell on the
  card, 2 x 4, tp, fp32: hymba-1.5b and rwkv6-3b at full width and 2
  layers, whisper-small's first 4 + 4 layers (8 x 64 tokens; whisper's
  decoder 8 x 64 over 256 frames): the step-1 loss and every gradient
  leaf over the mesh held to the meshless ones (TMESH_TOL; rwkv6's
  leaves, which its group norm leaves ill-conditioned, to the fixed
  FTMESH_RWKV_LEAF, and to TMESH_TOL with that norm's eps raised), one
  ``make_train_step`` each way, the mesh's with ZeRO-1 (ms and kernels a
  step, the mesh gradients' peak memory);
* training over a device mesh (``train_mesh``, a segment of its own
  with its own counts; it launches none of the six kernels), every
  cell on the card: llama3.2-1b whole on 2 x 4 (tp, ZeRO-1) in fp32,
  its step-1 loss and every gradient leaf held to the meshless step's,
  the update of the same gradients held to the meshless update, then
  three ``make_train_step`` steps each way (ms and kernels a step, peak
  memory, the placed m/v's bytes); ZeRO-1 off and on at llama's widths
  and 8 of its 16 layers on 4 x 2 (dp) in bf16, ``tests/test_zero1.py``'s
  bounds and the meshless losses; ``TrainLoop`` on SmolLM-135M in fp32,
  6 steps on 1 x 3 (tp) straight and an elastic resume of its step-3
  checkpoint onto 3 x 1 (dp, ZeRO-1) by ``try_resume(shardings)``, the
  losses after it held to the straight run's;
* the cost model (``cost_model_path``; it launches none of the five
  kernels): the dry-run CLI (``python -m
  repro_torch.launch.dryrun``), one process a cell at the lowest
  priority, traces on ``meta`` beside the corpus build (set-up) and is
  joined before the first timed phase, so no path runs beside it; it
  counts every ``cell_plan`` cell of SmolLM-135M and llama3.2-1b's
  ``decode_32k`` on one card (FLOPs, bytes, peak, ``fits``, the dominant
  term on the constants the card's name selects), SmolLM-135M's
  ``train_4k`` and ``decode_32k`` a chip of the 16 x 16 and 2 x 16 x 16
  production meshes (``--mesh both``: wire bytes by kind and the rate
  that priced them too) and extrapolates SmolLM-135M's and hymba-1.5b's
  ``prefill_32k`` from two depths (``--accounting``) on both meshes,
  hymba's on one card too; the path logs the records, then
  SmolLM-135M's train step (8 x 128, through ``make_train_step``), a
  prefill (8 x 512) and a decode step (8 at
  1,024 cached) are counted on ``meta`` and on the card: the same
  FLOPs, the predicted peak within PEAK_RTOL of
  ``max_memory_allocated``, each timed (median of COST_TIMED) beside its
  roofline bound (counted FLOPs, analytic minimum bytes) and ``mfu``,
  and the two-depth extrapolation equal to the full-depth count;
  ``HierAtlas`` over the search's corpus exports the flat atlas's
  device leaves, its anchor seeds pass their predicates inside the
  clusters it used, and its ``run_queries`` ids pass their predicates
  with recall@10 within 0.08 of the flat atlas's on the conjunctive
  Q=64 batch;
* the examples (``examples``), last, each script loaded from its file
  and run in process: ``examples/torch_rag_serve.py --full`` at its
  defaults on cuda:0 (SmolLM-135M whole encodes 2,048 documents of 32
  tokens, the index is built on the host and served on the card; 32
  queries under one predicate through ``retrieve`` and, after a warm-up,
  ``retrieve_batch``, whose first K1, K3 and WR calls are held to their
  plain versions), every id passing the predicate and the card's batched ids
  overlapping by at least 0.98 those of a ``device="cpu"`` service over
  the same embeddings (recall@10, ms a query and restarts logged); then
  ``examples/torch_train_lm.py --full --steps 30`` into a temporary
  ``--ckpt-dir`` (a checkpoint at step 25) and again on that directory:
  the second run resumes from the newest checkpoint and ends at the same
  last step, and the first run's last logged loss is below its first (ms
  a step and each checkpoint write logged).

Prints the kernels' timings as one JSON line (each record with its
share of its bound and its time against one PyTorch call, both from this
run), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without the ``ok`` line; so does a machine without CUDA or a
directory without the package. ``--report PATH`` also writes every
measurement (and a profiler breakdown of one batch) to PATH as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# CUDA-core FLOP/s and dense TF32 tensor-core FLOP/s; the kernels' scalar
# integer work is counted against the fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

N_PAPER = 105_100   # H&M corpus rows (paper size)
N_INSERT = 64 + 256 + 1024   # held-out rows, ingested in these batches
INSERT_BATCHES = (64, 256, 1024)
N_DELETE = 256      # rows the live-index phase deletes
N_SHARDS = 4        # the sharded path's row shards, all on the one card
SHARD_INSERT = 256  # held-out rows the sharded path ingests
SHARD_DELETE = 128  # rows it deletes (half of them inserted ones)
SERVE_INSERT = 256  # held-out rows the serve path ingests, journaled,
SERVE_CHUNK = 64    # in batches of this many
SERVE_DELETE = 128  # rows it deletes (half of them inserted ones)
SERVE_TAIL = 64     # rows ingested after the snapshot (journal only)
D = 2048
N_FIELDS = 24
K = 10              # results per query
Q_KERNEL = 256      # kernel-phase batch
SPIN_CYCLES = 2_000_000   # ~1 ms of spinning ahead of each timed run
# ~0.2 s of spinning queued ahead of the dispatch whose return is checked:
# longer than a batch's host enqueue, so the stream is still busy at the
# return unless the dispatch waited for the device
DISPATCH_SPIN_CYCLES = 400_000_000


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int, flush) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events around
    each run, the L2 cache flushed before each, after a warm-up). Each run
    is queued behind a spin kernel of ~1 ms, so the host has enqueued the
    flush and all of ``fn``'s launches before the first event fires: the
    time is the card's, not the wrapper's Python."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over their type's peak rate (fp32 unless given),
    with the side that binds."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k4_bytes(meta, fields, allowed) -> tuple[int, int]:
    """What K4 must move on this input, and the whole metadata's figure
    beside it. A row's later clause is needed only while the row passes
    every clause before it (the plain version's order), so it needs the
    first active clause's column for every row and a later column for the
    rows still passing, counted as the distinct 32-byte sectors they lie
    in; plus the tables read once and the words written once."""
    import torch
    n, F = meta.shape
    C, v_cap = allowed.shape
    tables = fields.numel() * 4 + allowed.numel() + (n + 31) // 32 * 4
    live = torch.ones(n, dtype=torch.bool, device=meta.device)
    sectors = []
    for c in range(C):
        f = int(fields[c])
        if f < 0:
            continue
        rows = torch.nonzero(live).squeeze(1)
        sectors.append((rows * F + f) * 4 // 32)
        code = meta[:, f].long()
        live &= ((code >= 0) & (code < v_cap)
                 & (allowed[c, code.clamp(0, v_cap - 1)] != 0))
    need = (int(torch.unique(torch.cat(sectors)).numel()) * 32
            if sectors else 0)
    return need + tables, meta.numel() * 4 + tables


def kernel_device_us(prof) -> float:
    """Device time of a ``torch.profiler`` trace: the sum over its kernel
    rows only (a torch op's row repeats the time of the kernels it
    launched, so a sum over every row counts that time twice)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def ratios(rec: dict) -> dict:
    """A timing record with its share of the bound (bound_ms / ms) and its
    time against the library call (ms / library_ms), both from one call."""
    lib = rec.get("library_ms")
    return {**rec, "share_of_bound": rec["bound_ms"] / rec["ms"],
            "vs_library": rec["ms"] / lib if lib else None}


def k2_work(q, ids, d: int) -> dict:
    """K2's bound on these inputs: the queries, each distinct valid row,
    every id and one pass word per valid id read once, both outputs
    written; 2·d operations per valid id."""
    import torch
    n_valid = int((ids >= 0).sum())
    n_rows = int(torch.unique(ids[ids >= 0]).numel())
    n_bytes = (q.numel() * 4 + n_rows * d * 4 + ids.numel() * 4
               + n_valid * 4 + 2 * ids.numel() * 4)
    b_ms, b_by = bound(n_bytes, 2.0 * d * n_valid)
    return dict(bound_ms=b_ms, bound_by=b_by, valid_ids=n_valid,
                distinct_rows=n_rows)


def k3_work(q, mask, bm, k: int, d: int) -> dict:
    """K3's bound on these inputs: the queries, each row some query's mask
    passes and the bitmap read once, (Q, k) sims and ids written. Its
    products are 3xTF32 on the tensor cores, so it is held to three TF32
    products per multiply-add at the TF32 peak; the fp32 CUDA-core bound
    is kept beside it."""
    set_bits = int(mask.sum())
    rows_any = int(mask.any(dim=0).sum())
    n_bytes = (q.numel() * 4 + rows_any * d * 4 + bm.numel() * 4
               + 2 * q.shape[0] * k * 4)
    n_ops = 2.0 * d * set_bits
    b_ms, b_by = bound(n_bytes, 3 * n_ops, TF32_FLOP_PER_S)
    fp32_ms, fp32_by = bound(n_bytes, n_ops)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=fp32_ms,
                bound_fp32_by=fp32_by, set_bits=set_bits, rows_any=rows_any)


def check_walk(label, got, want) -> float:
    """K2 against its plain version: identical -inf positions in both
    outputs and rtol = atol = 1e-5; returns the max abs error of sims."""
    import torch
    for g, w in zip(got, want):
        check(torch.equal(torch.isneginf(g), torch.isneginf(w)),
              f"{label}: -inf positions differ")
        check(torch.allclose(g, w, rtol=1e-5, atol=1e-5),
              f"{label}: kernel != plain at rtol=atol=1e-5")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() \
        else 0.0


def check_topk(label, got, want, mask, queries, corpus) -> tuple:
    """K3 against its plain version: identical fill, sims within 1e-4, and
    ids equal up to near-ties: where they differ, the kernel's id must pass
    the mask and score what the kernel says; no duplicates. Returns (max
    abs error, id mismatches)."""
    import torch
    (s_k, i_k), (s_p, i_p) = got, want
    fin = torch.isfinite(s_p)
    check(torch.equal(torch.isfinite(s_k), fin), f"{label}: fill")
    check(torch.allclose(s_k[fin], s_p[fin], rtol=1e-4, atol=1e-4),
          f"{label}: sims differ beyond 1e-4")
    diff = (i_k != i_p) & fin
    if diff.any():
        qi, _ = torch.nonzero(diff, as_tuple=True)
        kid = i_k[diff].long()
        check(bool(mask[qi, kid].all()), f"{label}: id fails mask")
        true = (corpus[kid] * queries[qi]).sum(1)
        check(torch.allclose(true, s_k[diff], rtol=1e-4, atol=1e-4),
              f"{label}: id does not score its sim")
    srt = i_k.sort(dim=1).values
    check(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0))
                   .any()), f"{label}: duplicate ids")
    tie = (s_k[:, 1:] == s_k[:, :-1]) & fin[:, 1:]
    check(bool((i_k[:, 1:] > i_k[:, :-1])[tie].all()),
          f"{label}: equal sims not in increasing id order")
    err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.0
    return err, int(diff.sum())


def check_expand(label, got, want) -> float:
    """K5 against its plain version: identical -inf positions and sims
    within 1e-4; returns the max abs error."""
    import torch
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          f"{label}: -inf positions differ")
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    check(err <= 1e-4, f"{label}: max abs err {err} > 1e-4")
    return err


ROUND_OVERLAP = 0.98   # walk_round vs walk_batch: mean per-lane id overlap
ROUND_EQUAL = 0.9      # ... least share of lanes with equal hops and term
ROUND_ERR = 1e-5       # ... most abs err of res_v where the ids agree


def check_round(label, got, want) -> dict:
    """walk_round against its plain version (walk_batch) on the same card
    inputs: a mean per-lane id-set overlap of the found results of at
    least ROUND_OVERLAP (the dots and the drift sum add in another order,
    so a near tie can turn a walk), at least a share ROUND_EQUAL of lanes
    with equal hops and equal termination codes, and res_v within
    ROUND_ERR wherever both hold the same id in the same slot (res_v is
    carried into the next round and decides early termination there).
    Returns these beside the exact share and the share of lanes with
    equal visited bits."""
    import numpy as np
    from repro_torch.core.batched.engine import INF
    gv, gi = got["res_v"].cpu().numpy(), got["res_i"].cpu().numpy()
    wv, wi = want["res_v"].cpu().numpy(), want["res_i"].cpu().numpy()
    a = [i[v < INF / 2] for v, i in zip(gv, gi)]
    b = [i[v < INF / 2] for v, i in zip(wv, wi)]
    mean = overlap(a, b)
    same = (wv < INF / 2) & (gi == wi)
    rec = dict(
        Q=len(a), mean_overlap=mean,
        exact_frac=float(np.mean([np.array_equal(x, y)
                                  for x, y in zip(a, b)])),
        hops_equal_frac=float((got["hops"] == want["hops"]).float().mean()),
        term_equal_frac=float((got["term"] == want["term"]).float().mean()),
        visited_equal_frac=float((got["visited_bm"] == want["visited_bm"])
                                 .all(dim=1).float().mean()),
        max_abs_err=float(np.abs(gv - wv)[same].max()) if same.any()
        else 0.0,
        mean_hops=float(want["hops"].float().mean()))
    check(mean >= ROUND_OVERLAP, f"{label}: kernel vs plain id-set "
                                 f"overlap {mean:.4f} < {ROUND_OVERLAP}")
    for key in ("hops_equal_frac", "term_equal_frac"):
        check(rec[key] >= ROUND_EQUAL,
              f"{label}: {key} {rec[key]:.4f} < {ROUND_EQUAL}")
    check(rec["max_abs_err"] <= ROUND_ERR, f"{label}: res_v max abs err "
          f"{rec['max_abs_err']:.3g} > {ROUND_ERR}")
    return rec


def round_work(args, plain) -> dict:
    """walk_round's bound on these inputs: the queries, seeds and carried
    results read once; each distinct corpus row some lane dots read once
    (a lane dots its seeds and each neighbour that is new or passes, the
    rows of its ``visited_bm``, so the rows are that bitmap ORed over
    lanes); each distinct adjacency row some lane expands read once
    (``walk_batch``'s ``expanded``); the pass and visited words probed
    not counted; the results, counts and visited bitmap written. 2·d
    operations per (lane, row) dot: each lane's valid seeds and
    ``walk_batch``'s ``dotted``."""
    from repro_torch.core.batched.bitmap import unpack_bits
    vectors, adjacency, pass_bm, q_vecs, seeds, res_v, _, p = args
    Q, d = q_vecs.shape
    rows = int(unpack_bits(plain["visited_bm"], vectors.shape[0])
               .any(dim=0).sum())
    adj_rows = int(plain["expanded"].sum())
    dots = int((seeds >= 0).sum()) + int(plain["dotted"].sum())
    n_bytes = (4 * (q_vecs.numel() + seeds.numel()) + 8 * res_v.numel()
               + 4 * d * rows + 4 * adjacency.shape[1] * adj_rows
               + 8 * res_v.numel() + 12 * Q + 4 * pass_bm.numel())
    b_ms, b_by = bound(n_bytes, 2.0 * d * dots)
    return dict(bound_ms=b_ms, bound_by=b_by, rows_dotted=dots,
                distinct_rows=rows, distinct_adj_rows=adj_rows,
                total_hops=int(plain["hops"].sum()), mb=n_bytes / 1e6)


def round_args(datlas, vectors, adjacency, q_vecs, tables, pass_bm, p,
               processed=None, res=None):
    """walk_round's arguments for one restart round as ``atlas_round``
    builds them (seeds by the topk backend on the card, from ``res`` or
    empty results), and the clusters the round used."""
    import torch
    from repro_torch.core.batched.bitmap import popcount, unpack_bits
    from repro_torch.core.batched.engine import INF
    Q = q_vecs.shape[0]
    passes = unpack_bits(pass_bm, vectors.shape[0])
    if processed is None:
        processed = torch.zeros((Q, datlas.n_clusters), dtype=torch.bool,
                                device=q_vecs.device)
    gate = processed | ~(popcount(pass_bm) > 0)[:, None]
    seeds, used = datlas.select_anchors_batch(
        q_vecs, tables, gate, vectors, passes, n_seeds=p.n_seeds,
        c_max=p.c_max, backend="topk", disjunct_quota=p.disjunct_quota)
    if res is None:
        res = (torch.full((Q, p.k), INF, device=q_vecs.device),
               torch.full((Q, p.k), -1, dtype=torch.int32,
                          device=q_vecs.device))
    return ((vectors, adjacency, pass_bm, q_vecs, seeds.contiguous(), *res,
             p), processed | used)


def round_case(label, args, flush=None) -> dict:
    """walk_round and walk_batch on one round's arguments: held by
    ``check_round``, each timed where ``flush`` is given (the kernel 20
    runs, the plain loop 3), with the bound (``round_work``), both
    versions' longest lane (max hops), the kernel's ms a hop of its
    longest lane (its time over its max hops: the longest lane sets it)
    and the launch plan (ring slots, bytes and blocks an SM, grid,
    cluster size)."""
    import torch
    from repro_torch.core.batched.engine import walk_batch
    from repro_torch.kernels import walk_round as wr

    def plain():
        return walk_batch(*args[:5], args[7], init_results=args[5:7])

    want = plain()
    got = wr.walk_round(*args)
    rec = check_round(label, got, want)
    torch.cuda.synchronize()
    rec.update(round_work(args, want))
    rec.update(plain_max_hops=int(want["hops"].max()),
               max_hops=int(got["hops"].max()),
               plan=wr.plan_of(args[3], args[0].shape[0])._asdict())
    if flush is not None:
        rec.update(ms=cuda_ms(lambda: wr.walk_round(*args), 20, flush),
                   plain_ms=cuda_ms(plain, 3, flush), library_ms=None)
        rec["ms_per_hop_longest"] = rec["ms"] / max(1, rec["max_hops"])
        rec = ratios(rec)
    return rec


def k1_meta(n, vocab, gen, dev, unpopulated=0.03):
    """(n, F) int32 metadata on the card: field f's codes uniform in
    [0, vocab[f]), a share ``unpopulated`` of the entries -1."""
    import torch
    top = torch.as_tensor(vocab, device=dev, dtype=torch.float64)
    u = torch.rand(n, len(vocab), device=dev, generator=gen,
                   dtype=torch.float64)
    meta = (u * top).long().clamp(max=max(vocab) - 1)
    hole = torch.rand(n, len(vocab), device=dev, generator=gen) < unpopulated
    return torch.where(hole, -1, meta).to(torch.int32).contiguous()


def k1_tables(q_n, D, C, vocab, v_cap, gen, dev, *, fields_from=None,
              p_value=0.3, intervals=False, min_live=1):
    """Random K1 clause tables on the card, (Q, D, C): each live disjunct
    (min_live..D of them a query) tests 1..C distinct fields of
    ``fields_from`` (default all; -1 for the rest, -2 for dead
    disjuncts), each code below min(vocab, v_cap) allowed with
    probability ``p_value``. With ``intervals``, half the clauses are
    windows [lo, hi] (lo <= hi) and the others carry a row with lo > hi,
    which the kernels read as a bitmap clause. Returns (fields, allowed,
    n_disj, bounds or None)."""
    import torch
    from repro_torch.core.batched.bitmap import pack_bits

    def rand(*shape):
        return torch.rand(shape, device=dev, generator=gen)

    pool = torch.as_tensor(fields_from if fields_from is not None
                           else range(len(vocab)), device=dev)
    voc = torch.as_tensor(vocab, device=dev)
    fields = pool[torch.argsort(rand(q_n, D, pool.numel()), dim=2)[..., :C]]
    n_act = torch.randint(1, C + 1, (q_n, D, 1), device=dev, generator=gen)
    fields = torch.where(torch.arange(C, device=dev) < n_act, fields, -1)
    n_disj = torch.randint(min_live, D + 1, (q_n,), device=dev,
                           generator=gen, dtype=torch.int32)
    dead = torch.arange(D, device=dev)[None, :, None] >= n_disj[:, None, None]
    fields = torch.where(dead, -2, fields).to(torch.int32).contiguous()
    top = voc[fields.clamp(min=0).long()]                   # (Q, D, C)
    bits = ((rand(q_n, D, C, v_cap) < p_value)
            & (torch.arange(v_cap, device=dev) < top[..., None])
            & (fields >= 0)[..., None])
    allowed = pack_bits(bits.view(-1, v_cap)).view(q_n, D, C, v_cap // 32)
    bounds = None
    if intervals:
        lo = (rand(q_n, D, C) * top).long()
        hi = lo + (rand(q_n, D, C) * top * 0.5).long()
        iv = rand(q_n, D, C) < 0.5
        bounds = torch.stack([torch.where(iv, lo, hi + 1),
                              torch.where(iv, hi, lo)], dim=-1)
        bounds = bounds.to(torch.int32).contiguous()
    return fields, allowed.contiguous(), n_disj, bounds


def ragged_k1(dev, log) -> None:
    """K1 in its three forms, bit-exact against its plain version, at
    shapes across its tile and query-group edges: n % 32 != 0 and n % 256
    != 0, n < 32, F even (the padded shared-memory stride), Q = 1 and
    Q = group + 1 (the plan's group forced, so a second group holds one
    query; with D = 8 and Wv = 32 a group spans several table chunks),
    metadata codes -1 and >= v_cap, interval rows with lo > hi, and a
    batch whose clauses are all inactive (every row passes, pad bits 0)."""
    import torch
    from repro_torch.core.batched.bitmap import popcount
    from repro_torch.kernels import build, filter_eval, ref
    gen = torch.Generator(dev).manual_seed(4)
    plan = filter_eval.filter_plan
    # n, F, Q, forced group (None: the plan's), form, D, v_cap
    cases = ((1000, 27, 1, None, "conj", 1, 256),
             (1000, 26, 9, 8, "bounds", 8, 1024),
             (31, 8, 5, None, "inactive", 1, 64),
             (2049, 27, 70, None, "bounds", 2, 1024),
             (600, 5, 33, 32, "dnf", 8, 1024),
             (4133, 12, 17, 16, "conj", 1, 1024))
    for n, F, q_n, group, form, D, v_cap in cases:
        # codes up to v_cap + 99: some at or beyond v_cap
        vocab = [v_cap + 100] * F
        meta = k1_meta(n, vocab, gen, dev)
        fields, allowed, nd, bounds = k1_tables(
            q_n, D, 4, vocab, v_cap, gen, dev, intervals=form == "bounds")
        if form in ("conj", "inactive"):
            fields, allowed, nd = fields[:, 0].contiguous(), \
                allowed[:, 0].contiguous(), None
            if form == "inactive":
                fields = torch.full_like(fields, -1)
        rows, g, smem = plan(q_n, n, F, D if fields.ndim == 3 else 1, 4,
                             v_cap // 32, build.sm_count(dev))
        if group is not None:  # the plan with another group size
            def forced(*args, group=group):
                rows, _, smem = plan(*args)
                return rows, group, smem
            filter_eval.filter_plan = forced
        try:
            got = filter_eval.filter_eval_batch(meta, fields, allowed, nd,
                                                bounds)
        finally:
            filter_eval.filter_plan = plan
        want = ref.filter_eval_batch(meta, fields, allowed, nd, bounds)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"K1 {form} n={n} F={F} Q={q_n}: kernel != plain")
        if form == "inactive":  # n = 31: every row passes, no pad bit
            check(bool((got == (1 << n) - 1).all()), f"K1 n={n}: pad bits")
        log("ragged_k1", n=n, F=F, Q=q_n, form=form, D=D, v_cap=v_cap,
            rows=rows, group=group or g, smem=smem,
            pass_bits=int(popcount(got).sum()))


def k4_tables(C, n_active, vocab, v_cap, gen, dev, *, fields_from=None,
              p_value=0.3):
    """A random K4 table on the card: fields (C,) int32 with ``n_active``
    distinct fields of ``fields_from`` (default all) at random positions
    and -1 elsewhere; allowed (C, v_cap) uint8, each code below
    min(vocab, v_cap) of an active clause allowed with probability
    ``p_value``."""
    import torch
    pool = torch.as_tensor(fields_from if fields_from is not None
                           else range(len(vocab)), device=dev)
    pick = pool[torch.randperm(pool.numel(), device=dev,
                               generator=gen)[:n_active]]
    fields = torch.full((C,), -1, dtype=torch.int32, device=dev)
    pos = torch.randperm(C, device=dev, generator=gen)[:n_active]
    fields[pos] = pick.to(torch.int32)
    top = torch.as_tensor(vocab, device=dev)[fields.clamp(min=0).long()]
    allowed = ((torch.rand(C, v_cap, device=dev, generator=gen) < p_value)
               & (torch.arange(v_cap, device=dev) < top[:, None])
               & (fields >= 0)[:, None])
    return fields, allowed.to(torch.uint8).contiguous()


def ragged_k4(dev, log) -> None:
    """K4 bit-exact against its plain version: n % 32 != 0, n below one
    word and n with several words a warp (its grid is capped), odd and
    even F, F = 1, every clause inactive (every row passes, pad bits 0),
    inactive clauses between active ones, metadata codes -1 and >= v_cap,
    and v_cap 32 to 1024, one not a multiple of 32."""
    import torch
    from repro_torch.core.batched.bitmap import popcount
    from repro_torch.kernels import filter_eval, ref
    gen = torch.Generator(dev).manual_seed(5)
    # n, F, C, v_cap, active clauses
    cases = ((31, 8, 4, 64, 2), (1000, 27, 4, 256, 3),
             (4133, 26, 4, 1024, 4), (5000, 1, 1, 32, 1),
             (77_777, 5, 2, 1024, 2), (100_003, 12, 4, 100, 0),
             (1_200_001, 7, 4, 256, 3))
    for n, F, C, v_cap, n_act in cases:
        # codes up to v_cap + 99: some at or beyond v_cap
        vocab = [v_cap + 100] * F
        meta = k1_meta(n, vocab, gen, dev)
        fields, allowed = k4_tables(C, n_act, vocab, v_cap, gen, dev,
                                    p_value=0.6)
        got = filter_eval.filter_eval(meta, fields, allowed)
        want = ref.filter_eval(meta, fields, allowed)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"K4 n={n} F={F} C={C} v_cap={v_cap}: kernel != plain")
        passing = int(popcount(got))
        if n_act == 0:
            check(passing == n, f"K4 n={n}: every row must pass, pad bits 0")
        log("ragged_k4", n=n, F=F, C=C, v_cap=v_cap, active=n_act,
            pass_bits=passing)


def ragged_checks(dev, log) -> None:
    """Every kernel against its plain version off the path's shapes:
    K1 as ``ragged_k1`` says, K4 as ``ragged_k4`` says; for the rest
    n % 32 != 0, d % 4 != 0 (the kernels' 4-byte copy path), Q below and
    across the query tile, masks from sparse to dense, a corpus of 37 rows
    repeated (exact ties, which must come out lowest id first), and K5
    with every id -1, with no pass bit set and with every pass bit set."""
    import torch
    from repro_torch.core.batched.bitmap import pack_bits
    from repro_torch.kernels import fiber_expand, ref
    from repro_torch.kernels import masked_cosine_topk as mct
    ragged_k1(dev, log)
    ragged_k4(dev, log)
    gen = torch.Generator(dev).manual_seed(3)
    cases = ((1000, 37, 70, 7, 5, 0.3, None),
             (4133, 132, 130, 32, 50, 0.004, None),
             (2500, 64, 64, 10, 96, 0.9, None),
             (3000, 96, 20, 32, 8, 0.5, 37))
    for n, d, q_n, k, r, dens, distinct in cases:
        corpus = torch.randn(n, d, device=dev, generator=gen)
        if distinct:
            corpus = corpus[torch.arange(n, device=dev) % distinct]
        queries = torch.randn(q_n, d, device=dev, generator=gen)
        mask = torch.rand(q_n, n, device=dev, generator=gen) < dens
        bm = pack_bits(mask)
        err, mism = check_topk(
            f"K3 n={n} d={d} Q={q_n}",
            mct.masked_cosine_topk(queries, corpus, bm, k),
            ref.masked_cosine_topk(queries, corpus, bm, k), mask, queries,
            corpus)
        ids = torch.randint(-1, n, (q_n, r), device=dev, generator=gen,
                            dtype=torch.int32)
        e2 = check_walk(f"K2 n={n} d={d} Q={q_n}",
                        fiber_expand.fiber_expand_walk(queries, corpus, ids,
                                                       bm),
                        ref.fiber_expand_walk(queries, corpus, ids, bm))
        e5 = check_expand(f"K5 n={n} d={d} Q={q_n}",
                          fiber_expand.fiber_expand(queries, corpus, ids, bm),
                          ref.fiber_expand(queries, corpus, ids, bm))
        log("ragged", n=n, d=d, Q=q_n, k=k, R=r, density=dens,
            distinct_rows=distinct, k3_max_abs_err=err,
            k3_id_mismatches=mism, k2_max_abs_err=e2, k5_max_abs_err=e5)
    # K5: no id, no pass bit, every pass bit (d % 4 != 0 in the first two)
    for n, d, q_n, r, ids_kind, bits in ((700, 37, 9, 24, "none", "all"),
                                         (700, 130, 9, 96, "random", "none"),
                                         (700, 64, 200, 96, "random", "all")):
        corpus = torch.randn(n, d, device=dev, generator=gen)
        queries = torch.randn(q_n, d, device=dev, generator=gen)
        mask = torch.full((q_n, n), bits == "all", device=dev)
        bm = pack_bits(mask)
        ids = torch.randint(-1, n, (q_n, r), device=dev, generator=gen,
                            dtype=torch.int32)
        if ids_kind == "none":
            ids = torch.full_like(ids, -1)
        got = fiber_expand.fiber_expand(queries, corpus, ids, bm)
        e5 = check_expand(f"K5 ids={ids_kind} bits={bits} d={d}", got,
                          ref.fiber_expand(queries, corpus, ids, bm))
        log("ragged_k5", n=n, d=d, Q=q_n, R=r, ids=ids_kind, pass_bits=bits,
            finite=int(torch.isfinite(got).sum()), max_abs_err=e5)


def build_corpus(log):
    """The corpus (N_PAPER + N_INSERT rows, one recipe), the index over
    its first N_PAPER rows, and the held-out rows (vectors, metadata)."""
    from repro_torch.core.atlas import AnchorAtlas
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.graph import build_alpha_knn
    from repro_torch.core.search import FiberIndex
    from repro_torch.core.types import Dataset
    from repro_torch.data.synth import (SynthSpec, add_or_pair_fields,
                                        add_timestamp_field, make_dataset)
    t0 = time.time()
    full = make_dataset(SynthSpec(n=N_PAPER + N_INSERT, d=D,
                                  n_fields=N_FIELDS, n_components=350,
                                  seed=0))
    full = add_timestamp_field(add_or_pair_fields(full))
    ds = Dataset(full.vectors[:N_PAPER], full.metadata[:N_PAPER],
                 full.field_names, full.vocab_sizes)
    held = (full.vectors[N_PAPER:], full.metadata[N_PAPER:])
    t1 = time.time()
    stages = {}
    graph = build_alpha_knn(ds.vectors, config=FnsConfig(), times=stages)
    t2 = time.time()
    atlas = AnchorAtlas.build(ds, seed=0)
    t3 = time.time()
    log("host_build", data_s=t1 - t0, graph_s=t2 - t1,
        graph_stages=stages, atlas_s=t3 - t2,
        n=ds.n, d=ds.d, fields=ds.n_fields, graph_width=graph.r_pad,
        clusters=atlas.n_clusters, held_out=held[0].shape[0])
    return ds, FiberIndex(ds.vectors, ds.metadata, graph, atlas), held


def make_batches(ds):
    from repro_torch.core.types import Dataset
    from repro_torch.data.synth import (make_or_queries, make_queries,
                                        make_range_queries)
    # conjunctive filters over the 24 categorical fields (the OR and
    # timestamp fields get their own batches)
    base = Dataset(ds.vectors, ds.metadata[:, :N_FIELDS],
                   ds.field_names[:N_FIELDS], ds.vocab_sizes[:N_FIELDS])
    conj256 = make_queries(base, n_queries=256, seed=1)
    return {
        "conj_q64": conj256[:64],
        "conj_q256": conj256,
        "or_q64": (make_or_queries(ds, 1, 32) + make_or_queries(ds, 2, 32)),
        "range_q64": (make_range_queries(ds, 0.5, 21)
                      + make_range_queries(ds, 0.1, 21)
                      + make_range_queries(ds, 0.02, 22)),
    }


def kernel_phases(ds, index, batches, dev, flush, log):
    """Each kernel against its plain version on the card at its path's
    shapes; returns the per-kernel records (launches filled in later from
    the paths' runs)."""
    import numpy as np
    import torch
    from repro_torch.core.batched.bitmap import n_words, pack_bits, popcount
    from repro_torch.core.batched.engine import pack_query_batch
    from repro_torch.core.device_atlas import auto_v_cap
    from repro_torch.kernels import fiber_expand, filter_eval
    from repro_torch.kernels import masked_cosine_topk as mct
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.filter_eval import table_n_disj

    vocab = ds.vocab_sizes
    v_cap = auto_v_cap(max(v for by_f in index.atlas.cluster_index
                           for v in by_f))
    meta = torch.from_numpy(ds.metadata).to(dev)
    vectors = torch.from_numpy(ds.vectors).to(dev)
    W = n_words(meta.shape[0])
    records = {}

    # K1: conjunctive, OR (DNF) and range (DNF + bounds) tables, Q=256
    conj = batches["conj_q256"]
    forms = {
        "conj": conj,
        "dnf": (batches["or_q64"] * 4)[:Q_KERNEL],
        "bounds": (batches["range_q64"] * 4)[:Q_KERNEL],
    }
    k1, bitmaps, packed = {}, {}, {}
    for form, qs in forms.items():
        packed[form] = pack_query_batch(qs, v_cap=v_cap, vocab_sizes=vocab,
                                        device=dev)
        _, fields, allowed, bounds = packed[form]
        check((bounds is not None) == (form == "bounds"), f"K1 {form} form")
        nd = table_n_disj(fields) if fields.ndim == 3 else None
        got = filter_eval.filter_eval_batch(meta, fields, allowed, nd, bounds)
        want = ref.filter_eval_batch(meta, fields, allowed, nd, bounds)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 {form}: kernel != plain")
        bitmaps[form] = got
        k1[form] = dict(
            ms=cuda_ms(lambda: filter_eval.filter_eval_batch(
                meta, fields, allowed, nd, bounds), 20, flush),
            plain_ms=cuda_ms(lambda: ref.filter_eval_batch(
                meta, fields, allowed, nd, bounds), 5, flush),
            table_bytes=sum(t.numel() * 4 for t in (fields, allowed, bounds)
                            if t is not None),
            active_clauses=int((fields >= 0).sum()))
    pass_bm = bitmaps["conj"]
    # the conjunctive form is the main path's bulk traffic
    c = k1["conj"]
    n_bytes = meta.numel() * 4 + c["table_bytes"] + Q_KERNEL * W * 4
    b_ms, b_by = bound(n_bytes, 4.0 * meta.shape[0] * c["active_clauses"])
    records["filter_eval_batch"] = ratios(dict(
        name="filter_eval_batch", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/filter_eval.cu",
        replaces="src/repro/kernels/filter_eval.py:172", launches=0,
        max_abs_err=0.0, ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    log("K1", ok=True, **{f"{f}_{k}": v for f, r in k1.items()
                          for k, v in r.items()})

    # K2: walk hops at the search's Q=64 and the kernel phase's Q=256, R =
    # the adjacency width, d=2048
    rng = np.random.default_rng(0)
    adjacency = torch.from_numpy(index.graph.neighbors).to(dev)
    q_vecs = torch.from_numpy(np.stack([q.vector for q in conj])).to(dev)
    nodes = torch.from_numpy(rng.integers(0, ds.n, Q_KERNEL)).to(dev)
    ids = adjacency[nodes].contiguous()
    R = ids.shape[1]
    k2 = {}
    for q_n in (Q_KERNEL, 64):
        qv = q_vecs[:q_n].contiguous()
        ids_q = ids[:q_n].contiguous()
        bm_q = pass_bm[:q_n].contiguous()
        err = check_walk(
            f"K2 Q={q_n}",
            fiber_expand.fiber_expand_walk(qv, vectors, ids_q, bm_q),
            ref.fiber_expand_walk(qv, vectors, ids_q, bm_q))
        safe_q = ids_q.clamp(min=0).long().flatten()

        def k2_library(qv=qv, safe_q=safe_q, q_n=q_n):
            rows = vectors.index_select(0, safe_q).view(q_n, R, D)
            return torch.bmm(rows, qv.unsqueeze(2))

        k2[f"q{q_n}"] = ratios(dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fiber_expand.fiber_expand_walk(
                qv, vectors, ids_q, bm_q), 50, flush),
            plain_ms=cuda_ms(lambda: ref.fiber_expand_walk(
                qv, vectors, ids_q, bm_q), 20, flush),
            library_ms=cuda_ms(k2_library, 20, flush),
            **k2_work(qv, ids_q, D)))
    m = k2[f"q{Q_KERNEL}"]
    n_valid = m["valid_ids"]
    safe = ids.clamp(min=0).long().flatten()
    records["fiber_expand_walk"] = ratios(dict(
        name="fiber_expand_walk", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/fiber_expand.cu",
        replaces="src/repro/kernels/fiber_expand.py:52", launches=0,
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m["library_ms"], shapes=k2))
    log("K2", R=R, **{f"{lbl}_{k}": v for lbl, r in k2.items()
                      for k, v in r.items()})

    # K3: k=10 over a one-cluster mask (the seed path's slot masks: each
    # query's best cluster), and k=32 over a random half of the corpus
    assign = torch.from_numpy(index.atlas.assign.astype(np.int64)).to(dev)
    cents = torch.from_numpy(index.atlas.centroids).to(dev)
    best = (q_vecs @ cents.T).argmax(dim=1)
    masks = {
        "one_cluster_k10": (assign[None, :] == best[:, None], 10),
        "random_k32": (torch.rand(Q_KERNEL, ds.n, device=dev,
                                  generator=torch.Generator(dev).manual_seed(0))
                       < 0.5, 32),
    }
    k3 = {}
    for label, (mask, k) in masks.items():
        bm = pack_bits(mask)
        err, mism = check_topk(
            f"K3 {label}", mct.masked_cosine_topk(q_vecs, vectors, bm, k),
            ref.masked_cosine_topk(q_vecs, vectors, bm, k), mask, q_vecs,
            vectors)

        def k3_library(mask=mask, k=k):
            return torch.topk(torch.where(mask, q_vecs @ vectors.T,
                                          float("-inf")), k)

        k3[label] = ratios(dict(
            ms=cuda_ms(lambda: mct.masked_cosine_topk(q_vecs, vectors, bm, k),
                       10, flush),
            plain_ms=cuda_ms(lambda: ref.masked_cosine_topk(
                q_vecs, vectors, bm, k), 5, flush),
            library_ms=cuda_ms(k3_library, 5, flush), max_abs_err=err,
            id_mismatches=mism, k=k, **k3_work(q_vecs, mask, bm, k, D)))
    m = k3["one_cluster_k10"]
    records["masked_cosine_topk"] = ratios(dict(
        name="masked_cosine_topk", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/masked_cosine_topk.cu",
        replaces="src/repro/kernels/masked_cosine_topk.py:61", launches=0,
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m["library_ms"], shapes=k3))
    log("K3", ok=True, **{f"{lbl}_{k}": v for lbl, r in k3.items()
                          for k, v in r.items()})

    # K4: one conjunctive query over the whole metadata, C=4, v_cap=256
    pred = max((q.predicate for q in conj), key=lambda p: p.n_clauses)
    f_np, a_np = ops.predicate_tables(pred, meta.shape[1], max_clauses=4,
                                      v_cap=256)
    fields1 = torch.from_numpy(f_np).to(dev)
    allowed1 = torch.from_numpy(a_np).to(dev)
    got = filter_eval.filter_eval(meta, fields1, allowed1)
    want = ref.filter_eval(meta, fields1, allowed1)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K4: kernel != plain (bits differ)")
    active = int((fields1 >= 0).sum())
    n_bytes, full_bytes = k4_bytes(meta, fields1, allowed1)
    b_ms, b_by = bound(n_bytes, 4.0 * meta.shape[0] * active)
    records["filter_eval"] = ratios(dict(
        name="filter_eval", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/filter_eval.cu",
        replaces="src/repro/kernels/filter_eval.py:276", launches=0,
        max_abs_err=0.0,
        ms=cuda_ms(lambda: filter_eval.filter_eval(meta, fields1, allowed1),
                   50, flush),
        plain_ms=cuda_ms(lambda: ref.filter_eval(meta, fields1, allowed1),
                         10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        needed_mb=n_bytes / 1e6,
        metadata_bound_ms=bound(full_bytes, 0)[0]))
    log("K4", active_clauses=active, pass_rows=int(popcount(got)),
        **records["filter_eval"])

    # K5: the K2 shapes (Q=256, R=96, d=2048), one pass-masked output
    s_p = ref.fiber_expand(q_vecs, vectors, ids, pass_bm)
    err = check_expand("K5", fiber_expand.fiber_expand(q_vecs, vectors, ids,
                                                       pass_bm), s_p)
    fin = torch.isfinite(s_p)
    n_pass = int(fin.sum())
    pass_rows = int(torch.unique(ids[fin]).numel())
    # the kernel reads a row only where its pass bit is set
    n_bytes = (q_vecs.numel() * 4 + ids.numel() * 4 + n_valid * 4
               + pass_rows * D * 4 + ids.numel() * 4)
    b_ms, b_by = bound(n_bytes, 2.0 * D * n_pass)
    ok_mask = ref.fiber_expand(q_vecs, vectors, ids, pass_bm).isfinite()

    def k5_library():
        rows = vectors.index_select(0, safe).view(Q_KERNEL, R, D)
        sims = torch.bmm(rows, q_vecs.unsqueeze(2)).squeeze(2)
        return torch.where(ok_mask, sims, float("-inf"))

    records["fiber_expand"] = ratios(dict(
        name="fiber_expand", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/fiber_expand.cu",
        replaces="src/repro/kernels/fiber_expand.py:91", launches=0,
        max_abs_err=err,
        ms=cuda_ms(lambda: fiber_expand.fiber_expand(
            q_vecs, vectors, ids, pass_bm), 50, flush),
        plain_ms=cuda_ms(lambda: ref.fiber_expand(
            q_vecs, vectors, ids, pass_bm), 20, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(k5_library, 20, flush)))
    log("K5", R=R, valid_ids=n_valid, passing_ids=n_pass,
        distinct_passing_rows=pass_rows, **records["fiber_expand"])

    # walk_round: the first restart round of the search's batches, seeded
    # as the search seeds them; conj Q=64 also its second round, from the
    # first round's results
    from repro_torch.core.config import WalkConfig
    from repro_torch.core.device_atlas import DeviceAtlas
    from repro_torch.kernels import walk_round as wr
    p = WalkConfig(k=K)
    datlas = DeviceAtlas.from_atlas(index.atlas, device=dev)
    check(datlas.v_cap == v_cap, "walk_round: the atlas's v_cap")
    rounds = {}
    for label, form, q_n in (("conj_q64", "conj", 64),
                             ("conj_q256", "conj", Q_KERNEL),
                             ("or_q64", "dnf", 64),
                             ("range_q64", "bounds", 64)):
        qv, *tables = (None if x is None else x[:q_n].contiguous()
                       for x in packed[form])
        tables = tuple(x for x in tables if x is not None)
        args, used = round_args(datlas, vectors, adjacency, qv, tables,
                                bitmaps[form][:q_n].contiguous(), p)
        rounds[label] = round_case(f"walk_round {label}", args, flush)
        if label == "conj_q64":
            first = wr.walk_round(*args)
            args2, _ = round_args(datlas, vectors, adjacency, qv, tables,
                                  args[2], p, processed=used,
                                  res=(first["res_v"], first["res_i"]))
            rounds["conj_q64_round2"] = round_case(
                "walk_round conj_q64 round 2", args2, flush)
    m = rounds["conj_q64"]
    records["walk_round"] = ratios(dict(
        name="walk_round", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/walk_round.cu",
        replaces="src/repro/core/batched/engine.py:262", launches=0,
        max_abs_err=max(r["max_abs_err"] for r in rounds.values()),
        ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=None, shapes=rounds))
    log("walk_round", **{f"{lbl}_{k}": v for lbl, r in rounds.items()
                         for k, v in r.items()})
    del datlas
    ragged_checks(dev, log)
    return records


# the kernels each driven path must launch: a search K1, K3 and the walk
# round; the parity gate K1-K5 (K2, K4 and K5 only there)
SEARCH_KERNELS = ("filter_eval_batch", "walk_round", "masked_cosine_topk")
GATE_KERNELS = ("fiber_expand_walk", "filter_eval", "fiber_expand")
PARITY_KERNELS = ("filter_eval_batch", "masked_cosine_topk") + GATE_KERNELS


def path_launches(path: str, kernels, log) -> dict:
    """The launch counts a path left (cleared just before it); fails if a
    kernel of the path never launched."""
    from repro_torch.kernels import build
    launches = dict(build.LAUNCHES)
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{path} never launched {name}")
    log(f"{path}_launches", **launches)
    return launches


def check_results(name, ids, masks, allowed_ids=None):
    """Per query: at most k ids, no duplicates, each passes its predicate
    (``masks[qi]`` over the corpus) and, where given, lies in
    ``allowed_ids``."""
    import numpy as np
    for qi, row in enumerate(ids):
        check(row.size <= K, f"{name}[{qi}]: more than k results")
        check(np.unique(row).size == row.size, f"{name}[{qi}]: dupes")
        check(bool(masks[qi][row].all()),
              f"{name}[{qi}]: a result fails its predicate")
        if allowed_ids is not None:
            check(bool(np.isin(row, allowed_ids).all()),
                  f"{name}[{qi}]: a deleted or unwritten row came back")


def parity_path(log) -> dict:
    """The port's kernel/plain-version parity gate on the card (the path
    that runs K4 and K5); any mismatch raises."""
    from repro_torch.kernels import build
    from repro_torch.kernels.parity import parity_gate
    build.LAUNCHES.clear()
    t = time.time()
    parity_gate("cuda")
    log("parity_gate", ok=True, s=time.time() - t)
    return path_launches("parity_gate", PARITY_KERNELS, log)


def ground_truth(ds, queries, dev):
    """Exact filtered top-K ids per query (host masks, card products)."""
    import numpy as np
    import torch
    vectors = torch.from_numpy(ds.vectors).to(dev)
    masks = torch.from_numpy(np.stack(
        [q.predicate.mask(ds.metadata, ds.vocab_sizes) for q in queries]))
    q_vecs = torch.from_numpy(np.stack([q.vector for q in queries])).to(dev)
    scores = torch.where(masks.to(dev), q_vecs @ vectors.T, float("-inf"))
    sims, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    sims, ids = sims[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy()
    return [i[np.isfinite(s)] for s, i in zip(sims, ids)], masks.numpy()


def main_path(ds, index, batches, dev, card, log, profile_into=None):
    """The fused search through the user entry point on the card; returns
    the results by batch for the host comparison."""
    import numpy as np
    import torch
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import build

    cfg = FnsConfig(walk=WalkConfig(k=K))
    t0 = time.time()
    eng = BatchedEngine(index, cfg, device=dev, vocab_sizes=ds.vocab_sizes)
    log("engine_build", s=time.time() - t0)
    gts = {name: ground_truth(ds, qs, dev) for name, qs in batches.items()}
    build.LAUNCHES.clear()
    results = {}
    for name, qs in batches.items():
        eng.search(qs)                      # warm-up (allocator, cuBLAS)
        torch.cuda.synchronize()
        t = time.time()
        token = eng.dispatch(qs)
        dispatch_ms = (time.time() - t) * 1e3
        # the device still searching when dispatch returns: nothing in it
        # waited for the device
        busy = not torch.cuda.current_stream().query()
        ids, stats = eng.collect(token)
        ms = (time.time() - t) * 1e3
        gt, masks = gts[name]
        check_results(name, ids, masks)
        rec = float(np.mean([recall_at_k(r, g) for r, g in zip(ids, gt)]))
        results[name] = dict(ids=ids, stats=stats, ms=ms, recall=rec)
        log("search", batch=name, Q=len(qs), ms_per_batch=ms,
            dispatch_return_ms=dispatch_ms, busy_at_return=busy,
            qps=len(qs) / ms * 1e3, recall_at_10=rec,
            mean_walks=float(stats["walks"].mean()),
            mean_hops=float(stats["hops"].mean()), syncs=stats["syncs"],
            rounds=stats["rounds"], card=card)
    # dispatch returns before the device is done: with DISPATCH_SPIN of
    # device work queued ahead, a dispatch that waited for the device would
    # return only after it (and find the stream idle)
    qs = batches["conj_q64"]
    torch.cuda.synchronize()
    torch.cuda._sleep(DISPATCH_SPIN_CYCLES)
    t = time.time()
    token = eng.dispatch(qs)
    dispatch_ms = (time.time() - t) * 1e3
    busy = not torch.cuda.current_stream().query()
    ids, _ = eng.collect(token)
    log("search_async", batch="conj_q64", busy_at_return=busy,
        dispatch_return_ms=dispatch_ms,
        spin_then_collect_ms=(time.time() - t) * 1e3)
    check(busy, f"search conj_q64: the stream was idle when dispatch "
                f"returned ({dispatch_ms:.2f} ms)")
    check(all(np.array_equal(a, b) for a, b in
              zip(ids, results["conj_q64"]["ids"])),
          "search conj_q64: ids differ between two dispatches")
    launches = path_launches("search", SEARCH_KERNELS, log)
    if profile_into is not None:
        from torch.profiler import ProfilerActivity, profile
        qs = batches["conj_q64"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.search(qs)
        rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
        profile_into["conj_q64"] = [
            dict(name=e.key, device_us=e.device_time_total,
                 self_device_us=e.self_device_time_total, calls=e.count)
            for e in rows[:30]]
        # the kernels' own rows: an op's row repeats its kernels' time
        profile_into["conj_q64_kernel_device_us"] = kernel_device_us(prof)
        profile_into["conj_q64_wall_us"] = (
            max(e.time_range.end for e in prof.events())
            - min(e.time_range.start for e in prof.events()))
    del eng
    return results, launches


def host_comparison(index, ds, batches, card_res, log):
    """The Q=64 conjunctive and OR batches through the host engine: per-lane
    id-set overlap with the card's answers (the OR batch also holds the
    disjunct-quota seeding, kernel calls on the card, to the host's dense
    products)."""
    import numpy as np
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    eng = BatchedEngine(index, FnsConfig(walk=WalkConfig(k=K)), device="cpu",
                        vocab_sizes=ds.vocab_sizes)
    for name in ("conj_q64", "or_q64"):
        t = time.time()
        ids, _ = eng.search(batches[name])
        mean = overlap(card_res[name]["ids"], ids)
        log("host_vs_card", batch=name, mean_overlap=mean,
            exact_match_frac=float(np.mean([
                np.array_equal(a, b)
                for a, b in zip(card_res[name]["ids"], ids)])),
            host_s=time.time() - t)
        check(mean >= 0.98,
              f"{name}: card vs host id-set overlap {mean:.4f} < 0.98")


def own_queries(vectors, metadata):
    """One query per row: the row's own vector and the conjunction of its
    first two populated categorical codes (the row passes it)."""
    from repro_torch.core.types import FilterPredicate, Query
    out = []
    for v, m in zip(vectors, metadata):
        fields = [f for f in range(N_FIELDS) if m[f] >= 0][:2]
        out.append(Query(vector=v, predicate=FilterPredicate.make(
            {f: [int(m[f])] for f in fields})))
    return out


def check_churn(label, search, vectors, metadata, vocab, keep, dead,
                live) -> str:
    """After inserts and deletes: every row of ``keep`` is found by its own
    vector and codes, and no row of ``dead`` comes back, neither to its
    own vector and codes nor to the unconstrained predicate; every answer
    passes its predicate and lies in ``live``. Rows are global ids, which
    index ``vectors`` and ``metadata``; ``search`` maps up to Q_KERNEL
    queries to their ids. Returns "found/kept"."""
    import numpy as np
    from repro_torch.core.types import FilterPredicate, Query

    def run(name, qs):
        ids = []
        for lo in range(0, len(qs), Q_KERNEL):
            part = qs[lo:lo + Q_KERNEL]
            got = search(part)
            check_results(f"{label}/{name}", got, np.stack(
                [q.predicate.mask(metadata, vocab) for q in part]), live)
            ids += got
        return ids

    ids = run("findable", own_queries(vectors[keep], metadata[keep]))
    found = sum(int(g) in r.tolist() for g, r in zip(keep, ids))
    check(found == keep.size,
          f"{label}: only {found}/{keep.size} inserted rows findable")
    dq = own_queries(vectors[dead], metadata[dead])
    run("deleted/own", dq)
    run("deleted/unconstrained",
        [Query(vector=q.vector, predicate=FilterPredicate.make({}))
         for q in dq])
    return f"{found}/{keep.size}"


def live_index(ds, index, held, batches, dev, card, log) -> dict:
    """The live-index path: a capacity-slab engine over the smoke's index
    ingests the held-out rows (deferred repair), the maintenance loop
    drains the backlog, a batch of rows is deleted, and the churned index
    is searched. Returns the path's launch counts."""
    import copy

    import numpy as np
    import torch
    from repro_torch.core.atlas import AnchorAtlas
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.core.search import FiberIndex
    from repro_torch.core.types import FilterPredicate, Query
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import build
    from repro_torch.serve.maintenance import MaintenanceLoop

    # the 24 categorical and 2 OR fields: the insert path refuses codes at
    # or above the atlas value range (v_cap <= 1024), and the timestamp
    # field's codes reach 2^20. Same graph and clusters, atlas re-derived
    # for these fields.
    n_f = N_FIELDS + 2
    meta = np.ascontiguousarray(ds.metadata[:, :n_f])
    vocab = tuple(ds.vocab_sizes[:n_f])
    held_v, held_m = held[0], np.ascontiguousarray(held[1][:, :n_f])
    atlas = AnchorAtlas.from_assignment(index.atlas.centroids,
                                        index.atlas.assign, meta)
    cfg = FnsConfig(walk=WalkConfig(k=K)).with_knobs(
        {"serve.capacity": N_PAPER + N_INSERT,
         "maintenance.defer_repair": True})
    t = time.time()
    eng = BatchedEngine(FiberIndex(ds.vectors, meta, index.graph, atlas),
                        cfg, device=dev, vocab_sizes=vocab)
    torch.cuda.synchronize()
    log("live_engine_build", s=time.time() - t, capacity=N_PAPER + N_INSERT,
        graph_width=int(eng.adjacency.shape[1]))
    rng = np.random.default_rng(2)
    # the unconstrained predicate before any insert: the unwritten tail
    # must never surface
    free = [Query(vector=v, predicate=FilterPredicate.make({}))
            for v in held_v[rng.choice(N_INSERT, 64, replace=False)]]

    def timed_search(qs):
        """Warm-up + timed search; returns ids, stats and ms."""
        eng.search(qs)
        torch.cuda.synchronize()
        t = time.time()
        ids, stats = eng.search(qs)
        return ids, stats, (time.time() - t) * 1e3

    build.LAUNCHES.clear()
    ids = eng.search(free)[0]
    check_results("unconstrained/pre-insert", ids,
                  np.ones((len(free), N_PAPER + N_INSERT), bool),
                  np.arange(N_PAPER))

    inserted, off = [], 0
    for b in INSERT_BATCHES:
        torch.cuda.synchronize()
        t = time.time()
        inserted.append(eng.insert_batch(held_v[off:off + b],
                                         held_m[off:off + b]))
        torch.cuda.synchronize()
        dt = time.time() - t
        off += b
        log("insert", batch=b, ms=dt * 1e3, rows_per_s=b / dt, card=card)
    inserted = np.concatenate(inserted)
    check(np.array_equal(inserted, np.arange(N_PAPER, N_PAPER + N_INSERT)),
          "inserted gids are not the appended rows")
    loop = MaintenanceLoop(eng, eng.cfg.maintenance)
    t = time.time()
    drained = loop.run_until_idle()
    torch.cuda.synchronize()
    log("maintenance", ms=(time.time() - t) * 1e3, card=card, **drained,
        **{k: v for k, v in eng.insert_stats.items()
           if k in ("reclusters", "reverse_edge_repairs")})
    check(loop.idle and eng.state.pending_rows == 0, "backlog not drained")
    t = time.time()
    eng.refresh_device()
    torch.cuda.synchronize()
    log("refresh_from_slab", ms=(time.time() - t) * 1e3,
        slab_mb=eng.vectors.numel() * 4 / 2**20, card=card)

    dead = np.sort(np.concatenate([
        rng.choice(inserted, N_DELETE // 2, replace=False),
        rng.choice(N_PAPER, N_DELETE // 2, replace=False)]))
    torch.cuda.synchronize()
    t = time.time()
    check(eng.delete_batch(dead) == N_DELETE, "delete count")
    torch.cuda.synchronize()
    log("delete", rows=N_DELETE, ms=(time.time() - t) * 1e3, card=card)

    sh = eng.state.shards[0]
    live_rows = np.nonzero(sh.live)[0]
    live_gids = sh.global_ids[live_rows]
    all_meta = sh.metadata
    # gids are slab rows here (appended rows, no compaction)
    findable = check_churn("live", lambda qs: eng.search(qs)[0], sh.vectors,
                           all_meta, vocab, np.setdiff1d(inserted, dead),
                           dead, live_gids)

    # the post-churn conjunctive batch: timing, recall over the live rows
    qs = batches["conj_q64"]
    ids, stats, ms = timed_search(qs)
    masks = np.stack([q.predicate.mask(all_meta, vocab) for q in qs])
    check_results("post_churn", ids, masks, live_gids)
    vecs = torch.from_numpy(sh.vectors[live_rows]).to(dev)
    q_vecs = torch.from_numpy(np.stack([q.vector for q in qs])).to(dev)
    scores = torch.where(torch.from_numpy(masks[:, live_rows]).to(dev),
                         q_vecs @ vecs.T, float("-inf"))
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :K].cpu().numpy(), top_i[:, :K].cpu().numpy()
    gts = [live_gids[i[np.isfinite(s)]] for s, i in zip(top_s, top_i)]
    rec = float(np.mean([recall_at_k(r, g) for r, g in zip(ids, gts)]))
    launches = path_launches("live_index", SEARCH_KERNELS, log)
    log("post_churn", Q=len(qs), ms_per_batch=ms, qps=len(qs) / ms * 1e3,
        recall_at_10=rec, mean_walks=float(stats["walks"].mean()),
        mean_hops=float(stats["hops"].mean()), syncs=stats["syncs"],
        findable=findable, card=card)

    # the same churned state on the host: id-set overlap
    t = time.time()
    host = BatchedEngine.from_state(copy.deepcopy(eng.state), eng.cfg,
                                    device="cpu", vocab_sizes=eng.vocab_sizes)
    h_ids, _ = host.search(qs)
    mean = overlap(ids, h_ids)
    log("live_host_vs_card", mean_overlap=mean,
        exact_match_frac=float(np.mean([np.array_equal(a, b)
                                        for a, b in zip(ids, h_ids)])),
        host_s=time.time() - t)
    check(mean >= 0.98,
          f"post-churn card vs host id-set overlap {mean:.4f} < 0.98")
    return launches


def overlap(a_ids, b_ids) -> float:
    """Mean per-lane id-set overlap of two answers to one batch."""
    import numpy as np
    return float(np.mean([
        1.0 if a.size == b.size == 0 else
        np.intersect1d(a, b).size / max(a.size, b.size)
        for a, b in zip(a_ids, b_ids)]))


class FirstCalls:
    """While open, ``kernels.ops``' K1, K3 and WR entries keep the
    arguments of their first call (tensors cloned) and pass every call
    through."""

    def __init__(self, names=None):
        self.names = names or SEARCH_KERNELS
        self.seen = {}

    def __enter__(self):
        import torch
        from repro_torch.kernels import ops
        self.real = {name: getattr(ops, name) for name in self.names}

        def wrap(name):
            def fn(*args):
                if name not in self.seen:
                    self.seen[name] = tuple(
                        a.clone() if torch.is_tensor(a) else a for a in args)
                return self.real[name](*args)
            return fn

        for name in self.names:
            setattr(ops, name, wrap(name))
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self.real.items():
            setattr(ops, name, fn)


def check_first_calls(seen, label, log) -> None:
    """K1, K3 and walk_round on the card tensors a path's search gave them
    (``FirstCalls`` of one batch: on the sharded path the shard searched
    first), each against its plain version with the kernel phases'
    tolerances: K1 bit-exact, K3 as ``check_topk``, walk_round as
    ``check_round``. The launches these comparisons make are taken back
    out of the path's counts. The record's phase is the label's path
    (``sharded/conj_q64`` logs ``sharded_kernels``)."""
    import torch
    from repro_torch.core.batched.bitmap import popcount, unpack_bits
    from repro_torch.kernels import build, filter_eval, ref
    from repro_torch.kernels import masked_cosine_topk as mct
    saved = dict(build.LAUNCHES)
    rec = {}
    if "filter_eval_batch" in seen:
        a = seen["filter_eval_batch"]
        got = filter_eval.filter_eval_batch(*a)
        check(torch.equal(got, ref.filter_eval_batch(*a)),
              f"{label} K1: kernel != plain")
        rec.update(k1_n=a[0].shape[0], k1_tables=tuple(a[1].shape),
                   k1_bounds=a[4] is not None,
                   k1_pass_bits=int(popcount(got).sum()))
    if "walk_round" in seen:
        args = seen["walk_round"]
        rec.update({f"round_{k}": v for k, v in round_case(
            f"{label} walk_round", args).items()},
            round_n=args[0].shape[0], round_d=args[0].shape[1])
    if "masked_cosine_topk" in seen:
        q, corpus, bm, k = seen["masked_cosine_topk"]
        mask = unpack_bits(bm, corpus.shape[0])
        err, mism = check_topk(
            f"{label} K3", mct.masked_cosine_topk(q, corpus, bm, k),
            ref.masked_cosine_topk(q, corpus, bm, k), mask, q, corpus)
        rec.update(k3_n=corpus.shape[0], k3_q=q.shape[0], k3_k=k,
                   k3_set_bits=int(mask.sum()), k3_max_abs_err=err,
                   k3_id_mismatches=mism)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.LAUNCHES.update(saved)
    log(label.split("/")[0] + "_kernels", batch=label, **rec)


class Segments:
    """A path driven in segments inside other paths (the mesh path runs
    inside the sharded and serving paths, on their index and snapshot):
    each segment runs with the launch counts set to 0 just before it and
    read just after, into this path's counts, and the enclosing path's
    counts are put back."""

    def __init__(self, name: str):
        self.name, self.launches, self.s = name, {}, 0.0

    def run(self, fn):
        from repro_torch.kernels import build
        saved = dict(build.LAUNCHES)
        build.LAUNCHES.clear()
        t = time.time()
        out = fn()
        self.s += time.time() - t
        for k, v in build.LAUNCHES.items():
            self.launches[k] = self.launches.get(k, 0) + v
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
        return out

    def finish(self, kernels, log) -> dict:
        for name in kernels:
            check(self.launches.get(name, 0) > 0,
                  f"{self.name} never launched {name}")
        log(f"{self.name}_launches", **self.launches)
        log(f"{self.name}_path", s=self.s)
        return self.launches


class SyncChecked:
    """While open, every ``dispatch`` of a ``BatchedEngine`` or
    ``ShardedEngine`` on the card runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside it
    raises, and every ``collect`` of one must report ``stats["syncs"]``
    1: the copy of the results is the batch's one host read."""

    def __init__(self):
        self.dispatches = self.collects = 0

    def __enter__(self):
        import torch
        from repro_torch.core.batched.engine import BatchedEngine
        from repro_torch.core.batched.sharded import ShardedEngine
        self.real = [(cls, cls.dispatch, cls.collect)
                     for cls in (BatchedEngine, ShardedEngine)]
        for cls, real_dispatch, real_collect in self.real:
            def dispatch(eng, *args, _real=real_dispatch, **kw):
                if eng.device.type != "cuda":
                    return _real(eng, *args, **kw)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = _real(eng, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                self.dispatches += 1
                return out

            def collect(eng, token, _real=real_collect):
                ids, stats = _real(eng, token)
                if eng.device.type == "cuda":
                    self.collects += 1
                    check(stats["syncs"] == 1, f"a batch took "
                          f"{stats['syncs']} host syncs, not 1")
                return ids, stats

            cls.dispatch, cls.collect = dispatch, collect
        return self

    def __exit__(self, *exc):
        for cls, real_dispatch, real_collect in self.real:
            cls.dispatch, cls.collect = real_dispatch, real_collect


def mesh_search(sidx, cfg, ref_eng, batches, ref_out, dev, card,
                log) -> None:
    """The mesh path's search segment: the sharded path's index on a 1D
    mesh of N_SHARDS cells, all on the one card, answers the conjunctive
    Q=64, OR and range batches with the ids, walks and hops of reference
    mode (``ref_out``) exactly, one dispatch a batch; each batch's first
    calls of K1, K3 and WR (on shard 0's cell) are held to their plain
    versions.
    Reference mode (``ref_eng``) runs the conjunctive batch again right
    after the mesh, for a time taken beside the mesh's; the batch then
    runs once more, exactly as well, on an N_SHARDS x 2 data x query mesh
    (two lanes of 32 queries)."""
    import numpy as np
    import torch
    from repro_torch.core.batched.sharded import ShardedEngine
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh, make_serving_mesh

    def same(name, ids, stats):
        want_ids, want = ref_out[name]
        return (len(ids) == len(want_ids)
                and all(np.array_equal(a, b) for a, b in zip(ids, want_ids))
                and np.array_equal(stats["walks"], want["walks"])
                and np.array_equal(stats["hops"], want["hops"]))

    def timed(eng, qs):
        torch.cuda.synchronize()
        t = time.time()
        out = eng.search(qs)
        return out, (time.time() - t) * 1e3

    def record(mesh_name, eng, name, out, ms, **extra):
        ids, stats = out
        exact = same(name, ids, stats)
        log("mesh_search", mesh=mesh_name, batch=name, Q=len(ids),
            lanes=eng.q_lanes, ms_per_batch=ms, exact=exact,
            overlap_with_reference_mode=overlap(ids, ref_out[name][0]),
            syncs=stats["syncs"], card=card, **extra)
        check(exact, f"mesh {mesh_name} {name}: ids, walks or hops differ "
                     f"from reference mode's")

    eng = ShardedEngine(sidx, make_local_mesh(N_SHARDS,
                                              devices=[dev] * N_SHARDS), cfg)
    checked = set()
    for name in ("conj_q64", "or_q64", "range_q64"):
        d0 = eng.dispatches
        with FirstCalls() as seen:
            out, ms = timed(eng, batches[name])
        check(eng.dispatches - d0 == 1, f"mesh data4 {name}: dispatches")
        after = {}
        if name == "conj_q64":   # its launches are not the mesh path's
            saved = dict(build.LAUNCHES)
            after["reference_mode_ms_after"] = timed(ref_eng,
                                                     batches[name])[1]
            build.LAUNCHES.clear()
            build.LAUNCHES.update(saved)
        check_first_calls(seen, f"mesh/{name}", log)
        checked |= set(seen)
        record("data4", eng, name, out, ms, **after)
    check(checked == set(SEARCH_KERNELS),
          f"mesh: kernels never checked on a cell: "
          f"{sorted(set(SEARCH_KERNELS) - checked)}")
    qs = batches["conj_q64"]
    del eng
    eng = ShardedEngine(sidx, make_serving_mesh(
        N_SHARDS, 2, devices=[dev] * (2 * N_SHARDS)), cfg)
    out, ms = timed(eng, qs)
    check(eng.dispatches == 1, "mesh data4xquery2: dispatches")
    record("data4xquery2", eng, "conj_q64", out, ms)


def sharded_path(ds, held, batches, card_res, dev, card, log,
                 mesh: Segments) -> dict:
    """The sharded engine in reference mode on the card: the corpus in
    N_SHARDS row shards (capacity for the held-out rows), the conjunctive
    Q=64, OR and range batches through ``ShardedEngine(device="cuda")``
    (checked, timed, recall beside the unsharded engine's, ids against the
    same index on the host), then a live index from the same state (the
    timestamp field left out, as in ``live_index``): SHARD_INSERT held-out
    rows ingested, SHARD_DELETE rows deleted, the survivors findable and
    the deleted never returned; then the port's two sharded smokes. The
    mesh path's search segment (``mesh_search``) runs on the same index
    before the live index. Returns the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.core.batched import insert, lifecycle
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index,
                                                  index_from_state)
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import build

    cfg = FnsConfig(walk=WalkConfig(k=K)).with_knobs(
        {"serve.capacity": N_PAPER + N_INSERT})
    names = ("conj_q64", "or_q64", "range_q64")
    gts = {name: ground_truth(ds, batches[name], dev) for name in names}
    build.LAUNCHES.clear()
    t = time.time()
    sidx = build_sharded_index(ds.vectors, ds.metadata, N_SHARDS,
                               config=cfg, device=dev)
    torch.cuda.synchronize()
    log("sharded_build", s=time.time() - t, shards=N_SHARDS,
        rows_per_shard=sidx.rows_per_shard,
        graph_width=int(sidx.adjacency.shape[2]),
        clusters=int(sidx.datlas.centroids.shape[1]),
        vectors_mb=sidx.vectors.numel() * 4 / 2**20)
    eng = ShardedEngine(sidx, None, cfg, device=dev)
    card_ids, ref_out, checked = {}, {}, set()
    for name in names:
        qs = batches[name]
        # warm-up; the kernels' first calls (on shard 0) are held to their
        # plain versions
        with FirstCalls() as seen:
            eng.search(qs)
        torch.cuda.synchronize()
        check_first_calls(seen, f"sharded/{name}", log)
        checked |= set(seen)
        d0 = eng.dispatches
        t = time.time()
        ids, stats = eng.search(qs)
        ms = (time.time() - t) * 1e3
        check(eng.dispatches - d0 == N_SHARDS, f"sharded {name}: dispatches")
        gt, masks = gts[name]
        check_results(f"sharded/{name}", ids, masks, np.arange(N_PAPER))
        card_ids[name] = ids
        ref_out[name] = (ids, stats)
        log("sharded_search", batch=name, Q=len(qs), ms_per_batch=ms,
            qps=len(qs) / ms * 1e3,
            recall_at_10=float(np.mean([recall_at_k(r, g)
                                        for r, g in zip(ids, gt)])),
            unsharded_ms_per_batch=card_res[name]["ms"],
            unsharded_recall_at_10=card_res[name]["recall"],
            overlap_with_unsharded=overlap(ids, card_res[name]["ids"]),
            mean_walks=float(stats["walks"].mean()),
            mean_hops=float(stats["hops"].mean()), syncs=stats["syncs"],
            card=card)
    check(checked == set(SEARCH_KERNELS),
          f"sharded: kernels never checked on a shard: "
          f"{sorted(set(SEARCH_KERNELS) - checked)}")
    # the same index on the host
    host = ShardedEngine(sidx, None, cfg, device="cpu")
    for name in names:
        t = time.time()
        ids, _ = host.search(batches[name])
        mean = overlap(card_ids[name], ids)
        log("sharded_host_vs_card", batch=name, mean_overlap=mean,
            exact_match_frac=float(np.mean([
                np.array_equal(a, b)
                for a, b in zip(card_ids[name], ids)])),
            host_s=time.time() - t)
        check(mean >= 0.98, f"sharded {name}: card vs host id-set overlap "
                            f"{mean:.4f} < 0.98")
    del host
    mesh.run(lambda: mesh_search(sidx, cfg, eng, batches, ref_out, dev,
                                 card, log))

    # the live index: the same slabs without the timestamp field (the
    # insert path refuses codes at or above v_cap), re-emitted on the card
    n_f = N_FIELDS + 2
    state = eng.state
    del eng, sidx
    torch.cuda.empty_cache()
    for sl in state.shards:
        sl.metadata = np.ascontiguousarray(sl.metadata[:, :n_f])
    vocab = tuple(ds.vocab_sizes[:n_f])
    t = time.time()
    eng = ShardedEngine(index_from_state(state, vocab, device=dev), None,
                        cfg, device=dev)
    torch.cuda.synchronize()
    log("sharded_from_state", s=time.time() - t)
    held_v = held[0][:SHARD_INSERT]
    held_m = np.ascontiguousarray(held[1][:SHARD_INSERT, :n_f])
    torch.cuda.synchronize()
    t = time.time()
    gids = eng.insert_batch(held_v, held_m)
    torch.cuda.synchronize()
    dt = time.time() - t
    check(np.array_equal(gids, np.arange(N_PAPER, N_PAPER + SHARD_INSERT)),
          "sharded inserted gids are not the appended ids")
    t = time.time()
    eng.refresh_device()
    torch.cuda.synchronize()
    log("sharded_insert", rows=SHARD_INSERT, ms=dt * 1e3,
        rows_per_s=SHARD_INSERT / dt, publish_ms=(time.time() - t) * 1e3,
        stacked_mb=sum(x.numel() * x.element_size() for x in (
            eng.vectors, eng.adjacency, eng.metadata, eng.global_ids))
        / 2**20, card=card)
    rng = np.random.default_rng(4)
    dead = np.sort(np.concatenate([
        rng.choice(gids, SHARD_DELETE // 2, replace=False),
        rng.choice(N_PAPER, SHARD_DELETE // 2, replace=False)]))
    t = time.time()
    check(eng.delete_batch(dead) == SHARD_DELETE, "sharded delete count")
    torch.cuda.synchronize()
    log("sharded_delete", rows=SHARD_DELETE, ms=(time.time() - t) * 1e3)
    # metadata by global id (build rows, then the inserted rows in order)
    all_meta = np.concatenate([ds.metadata[:, :n_f], held_m])
    live = np.setdiff1d(np.arange(N_PAPER + SHARD_INSERT), dead)
    findable = check_churn(
        "sharded", lambda qs: eng.search(qs)[0],
        np.concatenate([ds.vectors, held_v]), all_meta, vocab,
        np.setdiff1d(gids, dead), dead, live)
    log("sharded_live", findable=findable,
        deleted=SHARD_DELETE, ok=True)
    del eng, state
    torch.cuda.empty_cache()
    for smoke in (insert._smoke, lifecycle._smoke):
        smoke(dev)
    return path_launches("sharded", SEARCH_KERNELS, log)


def dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 2**20


MESH_RECALL_GAP = 0.02   # mesh recovery's recall@10 vs the meshless one's


def mesh_recover(root, qs, rec_ids, corpus, live, dev, card, log) -> None:
    """The mesh path's serving segment: the serving path's durable root
    (a one-shard snapshot and a journal tail) recovered onto a two-cell
    mesh on the one card, so ``engine_from_state`` pads an empty slab on
    and the journal's rows replay into it, as the reference's recovery
    does. Its ``query_batch`` on the conjunctive Q=64 batch equals
    reference mode's on the same recovered state (ids, walks, hops), and
    its recall@10 against exact filtered top-k over the recovered corpus
    (``corpus``, a Dataset by global id; ``live``, the rows not deleted)
    is within MESH_RECALL_GAP of the meshless recovery's (``rec_ids``),
    the reference's own bar for a recovery across meshes
    (``tests/test_durability.py::test_recover_cross_mesh``). The two
    recoveries hold different index states (the replayed rows sit in
    their own shard with their own subgraph, and shard 0's graph lacks
    their reverse edges), so their ids are compared only in the log."""
    import numpy as np
    import torch
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  index_from_state)
    from repro_torch.core.types import Dataset
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serve.retrieval import RetrievalService

    t = time.time()
    svc = RetrievalService.recover(
        root, mesh=make_local_mesh(2, devices=[dev, dev]))
    torch.cuda.synchronize()
    recover_s = time.time() - t
    eng = svc._live_engine()
    check(eng is svc._sharded and eng.n_shards == 2,
          "mesh recover: not served by the two-shard mesh engine")
    t = time.time()
    ids, stats = svc.query_batch(np.stack([q.vector for q in qs]),
                                 [q.predicate for q in qs])
    ms = (time.time() - t) * 1e3
    # the same recovered state in reference mode: exactly the same answer
    # (its launches are not the mesh path's)
    saved = dict(build.LAUNCHES)
    ref = ShardedEngine(index_from_state(eng.state, eng.vocab_sizes,
                                         device=dev), None, eng.cfg,
                        device=dev)
    want_ids, want = ref.search(qs)
    del ref
    build.LAUNCHES.clear()
    build.LAUNCHES.update(saved)
    check(all(np.array_equal(a, b) for a, b in zip(ids, want_ids))
          and np.array_equal(stats["walks"], want["walks"])
          and np.array_equal(stats["hops"], want["hops"]),
          "mesh recover: ids, walks or hops differ from reference mode's "
          "on the same recovered state")
    check_results("mesh/recovered", ids, np.stack(
        [q.predicate.mask(corpus.metadata, corpus.vocab_sizes)
         for q in qs]), live)
    gt, _ = ground_truth(Dataset(corpus.vectors[live],
                                 corpus.metadata[live], corpus.field_names,
                                 corpus.vocab_sizes), qs, dev)
    gt = [live[g] for g in gt]
    recall = float(np.mean([recall_at_k(r, g) for r, g in zip(ids, gt)]))
    rec_recall = float(np.mean([recall_at_k(r, g)
                                for r, g in zip(rec_ids, gt)]))
    log("mesh_recover", s=recover_s, query_batch_ms=ms,
        shard_rows=[sh.n_valid for sh in eng.state.shards],
        recall_at_10=recall, meshless_recall_at_10=rec_recall,
        overlap_with_meshless=overlap(ids, rec_ids),
        exact_match_frac=float(np.mean([np.array_equal(a, b)
                                        for a, b in zip(ids, rec_ids)])),
        card=card)
    check(recall >= rec_recall - MESH_RECALL_GAP,
          f"mesh recover: recall@10 {recall:.4f} more than "
          f"{MESH_RECALL_GAP} under the meshless recovery's "
          f"{rec_recall:.4f}")


def serve_path(ds, index, held, batches, card_res, dev, card, log,
               mesh: Segments) -> dict:
    """The serving path (``serve/``): a ``RetrievalService(device="cuda")``
    over the smoke's index (no second build) with capacity for the
    held-out rows answers the conjunctive Q=64, OR and range batches
    through ``query_batch`` (checked, and held to the main path's ids), a
    37-query and a one-query batch (padded to their buckets), the Q=64
    batch one query at a time through ``ServePipeline`` (held to
    ``query_batch``) and 16 sequential host queries (``query``; the stall
    regimes by selectivity). Then a durable service over the same index
    without the timestamp field (the insert path refuses codes at or above
    v_cap, as in ``live_index``) ingests, deletes, snapshots and ingests
    once more into the journal only, and ``RetrievalService.recover``
    brings it back: equal staleness, the same ids, every surviving
    inserted row findable, no deleted row returned; then the parity gate
    runs on the card, as a recovery does. The mesh path's serving segment
    (``mesh_recover``) recovers the same root onto a mesh. Returns the
    path's launch counts (K1-K5 and WR)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.atlas import AnchorAtlas
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.core.search import FiberIndex, SearchParams
    from repro_torch.core.stall import regimes_by_selectivity
    from repro_torch.core.types import Dataset
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import build
    from repro_torch.kernels.parity import parity_gate
    from repro_torch.serve.pipeline import ServePipeline
    from repro_torch.serve.pipeline import _smoke as pipeline_smoke
    from repro_torch.serve.retrieval import RetrievalService

    cap = N_PAPER + N_INSERT
    cfg = FnsConfig(walk=WalkConfig(k=K)).with_knobs(
        {"serve.capacity": cap, "serve.queue_max_batch": 16})

    def batch(svc, qs):
        return svc.query_batch(np.stack([q.vector for q in qs]),
                               [q.predicate for q in qs])

    def exact_share(a_ids, b_ids):
        return float(np.mean([np.array_equal(a, b)
                              for a, b in zip(a_ids, b_ids)]))

    t_path = time.time()
    names = ("conj_q64", "or_q64", "range_q64")
    gts = {name: ground_truth(ds, batches[name], dev) for name in names}
    build.LAUNCHES.clear()
    svc = RetrievalService(index, SearchParams(k=K), capacity=cap,
                           config=cfg, device=dev, _ds=ds)
    t = time.time()
    svc.engine()
    torch.cuda.synchronize()
    log("serve_engine_build", s=time.time() - t, capacity=cap)
    served, checked = {}, set()

    def held_to_plain(label, fn):
        # one call whose K1, K3 and WR calls are rerun against the plain
        # versions
        with FirstCalls() as seen:
            out = fn()
        torch.cuda.synchronize()
        check_first_calls(seen, f"serve/{label}", log)
        checked.update(seen)
        return out

    for name in names:
        qs = batches[name]
        # warm-up, its kernel calls held to their plain versions
        held_to_plain(name, lambda: batch(svc, qs))
        t = time.time()
        ids, stats = batch(svc, qs)
        ms = (time.time() - t) * 1e3
        gt, masks = gts[name]
        check_results(f"serve/{name}", ids, masks)
        check(stats["walks"].shape == (len(qs),), f"serve/{name}: stats")
        mean = overlap(ids, card_res[name]["ids"])
        served[name] = ids
        log("serve_query_batch", batch=name, Q=len(qs), ms_per_batch=ms,
            qps=len(qs) / ms * 1e3,
            recall_at_10=float(np.mean([recall_at_k(r, g)
                                        for r, g in zip(ids, gt)])),
            overlap_with_main_path=mean,
            exact_match_frac=exact_share(ids, card_res[name]["ids"]),
            syncs=stats["syncs"], card=card)
        check(mean >= 0.98, f"serve {name}: query_batch vs main path "
                            f"id-set overlap {mean:.4f} < 0.98")
    eng = svc.engine()
    conj = batches["conj_q256"]
    for label, qs, bucket in (("q37", conj[64:101], 64),
                              ("q1", conj[101:102], cfg.serve.min_bucket)):
        if label == "q1":  # the one bucket no other call runs at
            held_to_plain(label, lambda: batch(svc, qs))
        d0 = eng.dispatches
        t = time.time()
        ids, stats = batch(svc, qs)
        ms = (time.time() - t) * 1e3
        masks = np.stack([q.predicate.mask(ds.metadata, ds.vocab_sizes)
                          for q in qs])
        check(len(ids) == len(qs) and stats["walks"].shape == (len(qs),),
              f"serve/{label}: results not sliced to the real queries")
        check(eng.dispatches - d0 == 1, f"serve/{label}: dispatches")
        check_results(f"serve/{label}", ids, masks)
        log("serve_query_batch", batch=label, Q=len(qs), bucket=bucket,
            ms_per_batch=ms, card=card)

    # the Q=64 conjunctive batch one query at a time through the pipeline,
    # after one untimed pipeline batch (its first Q=16 queries) whose
    # kernel calls are held to their plain versions
    qs = batches["conj_q64"]

    def pipe_batch():
        pipe = ServePipeline(svc)
        for q in qs[:cfg.serve.queue_max_batch]:
            pipe.submit(q.vector, q.predicate)
        return pipe.drain()

    check(held_to_plain("pipeline_q16", pipe_batch) == 1,
          "serve/pipeline: the first 16 queries were not one batch")
    pipe = ServePipeline(svc)
    t = time.time()
    tickets = []
    for q in qs:
        tickets.append(pipe.submit(q.vector, q.predicate))
        pipe.pump()
    pipe.drain()
    ms = (time.time() - t) * 1e3
    check(all(tk.done and tk.error is None for tk in tickets),
          "serve/pipeline: a ticket did not finish cleanly")
    p_ids = [tk.ids for tk in tickets]
    check_results("serve/pipeline", p_ids, gts["conj_q64"][1])
    mean = overlap(p_ids, served["conj_q64"])
    log("serve_pipeline", Q=len(qs), batches=pipe.batches,
        ms_per_query=ms / len(qs),
        p50_sojourn_ms=float(np.median([tk.sojourn_ms for tk in tickets])),
        overlap_with_query_batch=mean,
        exact_match_frac=exact_share(p_ids, served["conj_q64"]), card=card)
    check(mean >= 0.98, f"serve pipeline vs query_batch id-set overlap "
                        f"{mean:.4f} < 0.98")

    # the conjunctive Q=256 batch in batches of 16: through the pipeline
    # (batch N+1 formed and packed while batch N is on the card) and one
    # query_batch after another, in turns
    conj = batches["conj_q256"]
    step = cfg.serve.queue_max_batch

    def serial():
        return [i for lo in range(0, len(conj), step)
                for i in batch(svc, conj[lo:lo + step])[0]]

    def piped():
        pipe = ServePipeline(svc)
        tks = [pipe.submit(q.vector, q.predicate) for q in conj]
        while not all(tk.done for tk in tks):
            if pipe.pump() == 0 and len(pipe.queue) == 0:
                pipe.drain()
        check(pipe.batches == len(conj) // step, "serve/overlap: batches")
        return [tk.ids for tk in tks]

    turns = {"serial": [], "pipeline": []}
    outs = {}
    for name, fn in (("serial", serial), ("pipeline", piped),
                     ("pipeline", piped), ("serial", serial)):
        torch.cuda.synchronize()
        t = time.time()
        outs[name] = fn()
        torch.cuda.synchronize()
        turns[name].append((time.time() - t) * 1e3 / len(conj))
    mean = overlap(outs["pipeline"], outs["serial"])
    log("serve_pipeline_overlap", Q=len(conj), batch=step,
        serial_ms_per_query=turns["serial"],
        pipeline_ms_per_query=turns["pipeline"],
        overlap_with_serial=mean,
        exact_match_frac=exact_share(outs["pipeline"], outs["serial"]),
        card=card)
    check(mean >= 0.98, f"serve pipeline vs serial id-set overlap "
                        f"{mean:.4f} < 0.98")
    t = time.time()
    pipeline_smoke()
    log("serve_pipeline_smoke", ok=True, s=time.time() - t)

    # the sequential path (host numpy): 16 range queries across the sels
    rq = batches["range_q64"]
    picks = list(range(0, 6)) + list(range(21, 26)) + list(range(42, 47))
    gt, masks = gts["range_q64"]
    seq_stats, sels, recs = [], [], []
    t = time.time()
    for i in picks:
        ids, _, st = svc.query(rq[i].vector, rq[i].predicate, seed=i)
        check(ids.size <= K and bool(masks[i][ids].all()),
              f"serve/sequential[{i}]: a result fails its predicate")
        seq_stats.append(st)
        sels.append(float(masks[i].mean()))
        recs.append(recall_at_k(ids, gt[i]))
    seq_ms = (time.time() - t) * 1e3 / len(picks)
    log("serve_sequential", Q=len(picks), host_ms_per_query=seq_ms,
        recall_at_10=float(np.mean(recs)), device="host", card=card,
        regimes_by_selectivity=[
            r for r in regimes_by_selectivity(seq_stats, sels, recs)
            if r["n"]])
    del svc, eng, pipe
    torch.cuda.empty_cache()

    # the durable service: ingest, delete, snapshot, journal, recover
    n_f = N_FIELDS + 2
    meta = np.ascontiguousarray(ds.metadata[:, :n_f])
    vocab = tuple(ds.vocab_sizes[:n_f])
    held_v = held[0][:SERVE_INSERT + SERVE_TAIL]
    held_m = np.ascontiguousarray(held[1][:SERVE_INSERT + SERVE_TAIL, :n_f])
    atlas = AnchorAtlas.from_assignment(index.atlas.centroids,
                                        index.atlas.assign, meta)
    svc = RetrievalService(
        FiberIndex(ds.vectors, meta, index.graph, atlas), SearchParams(k=K),
        capacity=cap, config=cfg, device=dev,
        _ds=Dataset(ds.vectors, meta, ds.field_names[:n_f], list(vocab)))
    root = tempfile.mkdtemp(prefix="fns_serve_")
    try:
        t = time.time()
        svc.enable_durability(root, keep=2)   # the first snapshot
        log("serve_durable_build", s=time.time() - t,
            snapshot_mb=dir_mb(os.path.join(root, "snapshots")))
        gids = []
        t = time.time()
        for lo in range(0, SERVE_INSERT, SERVE_CHUNK):
            gids.append(svc.ingest(held_v[lo:lo + SERVE_CHUNK],
                                   held_m[lo:lo + SERVE_CHUNK]))
        torch.cuda.synchronize()
        dt = time.time() - t
        gids = np.concatenate(gids)
        check(np.array_equal(gids, np.arange(N_PAPER, N_PAPER + SERVE_INSERT)),
              "serve: inserted gids are not the appended rows")
        rng = np.random.default_rng(5)
        dead = np.sort(np.concatenate([
            rng.choice(gids, SERVE_DELETE // 2, replace=False),
            rng.choice(N_PAPER, SERVE_DELETE // 2, replace=False)]))
        check(svc.delete(dead) == SERVE_DELETE, "serve: delete count")
        t2 = time.time()
        step = svc.snapshot()
        snap_s = time.time() - t2
        snap_mb = dir_mb(os.path.join(root, "snapshots",
                                      f"step_{step:08d}"))
        tail = svc.ingest(held_v[SERVE_INSERT:], held_m[SERVE_INSERT:])
        gids = np.concatenate([gids, tail])
        log("serve_ingest", rows=SERVE_INSERT, chunk=SERVE_CHUNK,
            ms=dt * 1e3, rows_per_s=SERVE_INSERT / dt, deleted=SERVE_DELETE,
            snapshot_s=snap_s, snapshot_mb=snap_mb, journal_rows=SERVE_TAIL,
            journal_mb=os.path.getsize(os.path.join(root, "journal.bin"))
            / 2**20, card=card)
        qs = batches["conj_q64"]
        live_ids, _ = batch(svc, qs)
        live_stale = svc.staleness()
        del svc
        torch.cuda.empty_cache()

        t = time.time()
        rec = RetrievalService.recover(root, device=dev)
        torch.cuda.synchronize()
        recover_s = time.time() - t
        check(rec.staleness() == live_stale,
              "serve: recovered staleness differs from the live service's")
        rec_ids, _ = held_to_plain("recovered_conj_q64",
                                   lambda: batch(rec, qs))
        mean = overlap(rec_ids, live_ids)
        log("serve_recover", s=recover_s, overlap_with_live=mean,
            exact_match_frac=exact_share(rec_ids, live_ids),
            corpus_rows=live_stale["corpus_rows"], card=card)
        check(mean >= 0.98, f"serve: recovered vs live id-set overlap "
                            f"{mean:.4f} < 0.98")

        # metadata by global id: the build rows, then the inserted rows
        all_meta = np.concatenate([meta, held_m])
        all_vecs = np.concatenate([ds.vectors, held_v])
        live = np.setdiff1d(np.arange(all_meta.shape[0]), dead)

        findable = check_churn("serve", lambda qs: batch(rec, qs)[0],
                               all_vecs, all_meta, vocab,
                               np.setdiff1d(gids, dead), dead, live)
        log("serve_recovered_live", findable=findable,
            deleted=SERVE_DELETE, ok=True)
        corpus = Dataset(all_vecs, all_meta, ds.field_names[:n_f],
                         list(vocab))
        mesh.run(lambda: mesh_recover(root, qs, rec_ids, corpus, live, dev,
                                      card, log))
        del rec
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(checked == set(SEARCH_KERNELS),
          f"serve: kernels never held to their plain versions: "
          f"{sorted(set(SEARCH_KERNELS) - checked)}")
    t = time.time()
    parity_gate(dev)
    log("serve_parity_gate", ok=True, s=time.time() - t)
    launches = path_launches("serve", SEARCH_KERNELS + GATE_KERNELS, log)
    log("serve_path", s=time.time() - t_path)
    return launches


def time_first_calls(seen, label, dev, log) -> dict:
    """walk_round, K2 and K3 timed on the arguments of a path's first
    calls (``FirstCalls``), beside their plain versions, one PyTorch call
    each where there is one and their bound on these inputs
    (``round_work``, ``k2_work``, ``k3_work``). K2, which the search no
    longer calls, is timed on the first hop the round's lanes take: each
    lane's first seed's neighbours. The launches made here are taken back
    out of the path's counts."""
    import torch
    from repro_torch.core.batched.bitmap import unpack_bits
    from repro_torch.kernels import build, fiber_expand, ref
    from repro_torch.kernels import masked_cosine_topk as mct
    saved = dict(build.LAUNCHES)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    args = seen["walk_round"]
    rnd = round_case(f"{label} walk_round", args, flush)
    corpus, adjacency, bm, q, seeds = args[:5]
    ids = adjacency[seeds[:, 0].clamp(min=0).long()].contiguous()
    (Q, R), d = ids.shape, corpus.shape[1]
    safe = ids.clamp(min=0).long().flatten()

    def k2_library():
        rows = corpus.index_select(0, safe).view(Q, R, d)
        return torch.bmm(rows, q.unsqueeze(2))

    err = check_walk(f"{label} K2", fiber_expand.fiber_expand_walk(
        q, corpus, ids, bm), ref.fiber_expand_walk(q, corpus, ids, bm))
    k2 = ratios(dict(
        ms=cuda_ms(lambda: fiber_expand.fiber_expand_walk(q, corpus, ids, bm),
                   50, flush),
        plain_ms=cuda_ms(lambda: ref.fiber_expand_walk(q, corpus, ids, bm),
                         20, flush),
        library_ms=cuda_ms(k2_library, 20, flush), max_abs_err=err,
        **k2_work(q, ids, d)))
    q3, corpus3, bm3, k = seen["masked_cosine_topk"]
    mask = unpack_bits(bm3, corpus3.shape[0])

    def k3_library():
        return torch.topk(torch.where(mask, q3 @ corpus3.T, float("-inf")), k)

    k3 = ratios(dict(
        ms=cuda_ms(lambda: mct.masked_cosine_topk(q3, corpus3, bm3, k), 20,
                   flush),
        plain_ms=cuda_ms(lambda: ref.masked_cosine_topk(q3, corpus3, bm3, k),
                         5, flush),
        library_ms=cuda_ms(k3_library, 5, flush), k=k,
        **k3_work(q3, mask, bm3, k, d)))
    del flush
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    build.LAUNCHES.update(saved)
    rec = {"walk_round": dict(n=corpus.shape[0], d=d, **rnd),
           "K2": dict(Q=Q, R=R, n=corpus.shape[0], d=d, **k2),
           "K3": dict(Q=q3.shape[0], n=corpus3.shape[0], d=d, **k3)}
    log(label.split("/")[0] + "_kernel_times", batch=label,
        **{f"{name}_{key}": v for name, r in rec.items()
           for key, v in r.items()})
    return rec


# the rag path: SmolLM-135M at full width encodes a corpus and the prompts
# that retrieve from it (examples/rag_serve.py --full, at serving scale)
RAG_ARCH = "smollm-135m"
RAG_DOCS = 65_536     # documents encoded and indexed
RAG_LEN = 64          # tokens a document and a prompt
RAG_BATCH = 256       # documents an encode call
RAG_FIELDS = 6        # categorical fields of RAG_CODES codes each
RAG_CODES = 8
RAG_Q = 64            # prompts a retrieve_batch
RAG_SEQ = 8           # prompts through the sequential retrieve
RAG_TIMED = 5         # timed turns of retrieve_batch vs encode + query
RAG_CPU_DOCS = 256    # documents also encoded on the host, for the check
RAG_COS = 0.999       # least cosine of a card embedding to the host's
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 32, 16   # launch/serve.py's defaults


def rag_predicates(rng, q: int):
    """One conjunctive predicate per prompt over the RAG fields, a third
    each at selectivity 0.25 (one field, 2 codes), 0.047 (3 codes and 1)
    and 0.0098 (1, 1 and 5 codes)."""
    from repro_torch.core.types import FilterPredicate
    widths = [(2,), (3, 1), (1, 1, 5)]
    out = []
    for i in range(q):
        fields = rng.permutation(RAG_FIELDS)
        out.append(FilterPredicate.make({
            int(f): rng.choice(RAG_CODES, w, replace=False).tolist()
            for f, w in zip(fields, widths[i * 3 // q])}))
    return out


def encode_corpus(label, cfg, params, env, n_docs: int, batch: int, dev):
    """``n_docs`` documents of RAG_LEN tokens from ``TokenPipeline``
    (steps 0.. of seed 0, ``batch`` a step) encoded on the card in
    batches of ``batch``, after one warm-up batch (cuBLAS handles, the
    allocator). Returns the tokens, the (n_docs, d) fp32 rows on the host
    and the seconds the encode took; fails on a non-finite or non-unit
    row."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import encode
    pipe = TokenPipeline(cfg.vocab_size, batch, RAG_LEN, seed=0)
    docs = np.concatenate([pipe.get_batch(i)["tokens"]
                           for i in range(n_docs // batch)])
    docs_dev = torch.from_numpy(docs).to(dev)

    def enc(toks):
        return encode(params, {"tokens": toks}, cfg, env)

    enc(docs_dev[:batch])
    torch.cuda.synchronize()
    t = time.time()
    vectors = torch.cat([enc(docs_dev[lo:lo + batch])
                         for lo in range(0, n_docs, batch)]).cpu().numpy()
    enc_s = time.time() - t
    check(vectors.shape == (n_docs, cfg.d_model)
          and bool(np.isfinite(vectors).all()), f"{label}: encode output")
    check(bool(np.allclose(np.linalg.norm(vectors, axis=1), 1.0, atol=1e-5)),
          f"{label}: embeddings are not unit rows")
    return docs, vectors, enc_s


def serve_corpus(label, vectors, rng, dev, card, log):
    """RAG_FIELDS categorical fields of RAG_CODES codes drawn from
    ``rng`` for the rows of ``vectors``, the index built on the host at
    the ``FnsConfig`` defaults and served by ``RetrievalService`` on the
    card at k=K, its engine placed there. Returns (dataset, service)."""
    import numpy as np
    import torch
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.core.search import SearchParams
    from repro_torch.core.types import Dataset
    from repro_torch.serve.retrieval import RetrievalService
    n, d = vectors.shape
    meta = rng.integers(0, RAG_CODES, (n, RAG_FIELDS)).astype(np.int32)
    ds = Dataset(vectors, meta, [f"f{i}" for i in range(RAG_FIELDS)],
                 [RAG_CODES] * RAG_FIELDS)
    t = time.time()
    svc = RetrievalService.build(ds, config=FnsConfig(walk=WalkConfig(k=K)),
                                 params=SearchParams(k=K), device=dev)
    build_s = time.time() - t
    t = time.time()
    svc.engine()
    torch.cuda.synchronize()
    log(f"{label}_host_build", s=build_s, engine_s=time.time() - t, n=n,
        d=d, graph_width=svc.index.graph.r_pad,
        clusters=svc.index.atlas.n_clusters, card=card)
    return ds, svc


def first_batch(label, retr, prompts, preds, dev, log) -> dict:
    """``retr.retrieve_batch`` once as a warm-up: its first K1, K3 and
    walk_round calls held to their plain versions (``check_first_calls``)
    and walk_round, K2 and K3 timed on them (``time_first_calls``, whose
    record it returns)."""
    import torch
    with FirstCalls() as seen:
        retr.retrieve_batch(prompts, preds)
    torch.cuda.synchronize()
    path = label.split("/")[0]
    check(set(seen) == set(SEARCH_KERNELS),
          f"{path}: kernels never called: {set(SEARCH_KERNELS) - set(seen)}")
    check_first_calls(seen, label, log)
    return time_first_calls(seen, label, dev, log)


def rag_path(dev, card, log, lm_mesh) -> dict:
    """The LM retrieval bridge at SmolLM-135M's full width (30 layers, d
    576, 9 heads / 3 KV, vocab 49,152; random weights from ``init_params``
    with seed 0): RAG_DOCS documents from ``TokenPipeline`` encoded on the
    card in batches of RAG_BATCH, RAG_FIELDS categorical fields attached,
    the index built on the host at the ``FnsConfig`` defaults and served
    by ``RetrievalService(device="cuda")`` at k=10; then
    ``EncodedRetriever.retrieve_batch`` on RAG_Q prompts (one conjunctive
    predicate each, selectivities ≈ 0.25 / 0.05 / 0.01; its first K1, K3
    and walk_round calls held to their plain versions and walk_round, K2
    and K3 timed on them), timed
    RAG_TIMED times in turns with ``embed_tokens`` + ``query_batch`` of
    the same prompts (medians logged), whose ids it must equal in every
    turn; the ids must pass their predicates and be scored against exact filtered
    top-k; ``retrieve`` (the sequential host path) on RAG_SEQ prompts;
    RAG_CPU_DOCS card embeddings held to the port on the host with the
    same weights (cosine ≥ RAG_COS); ``ServeEngine.generate`` greedy at
    batch 4, prompt 32, 16 new tokens, equal across two calls, its first
    token the card prefill's argmax. The LM mesh path's retrieval segment
    (``rag_mesh``, in ``lm_mesh``'s counts) runs on the same service and
    prompts. Returns the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import Query
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build
    from repro_torch.models.transformer import (ShardEnv, encode,
                                                init_params, on_device,
                                                prefill)
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.retrieval import EncodedRetriever

    t_path = time.time()
    build.LAUNCHES.clear()
    cfg, env = get_config(RAG_ARCH), ShardEnv(None)
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())

    docs, vectors, enc_s = encode_corpus("rag", cfg, params, env, RAG_DOCS,
                                         RAG_BATCH, dev)
    log("rag_encode", docs=RAG_DOCS, tokens=RAG_LEN, batch=RAG_BATCH,
        s=enc_s, docs_per_s=RAG_DOCS / enc_s, params=n_params,
        layers=cfg.n_layers, d=cfg.d_model, card=card)

    # the same weights on the host: card embeddings held to the port's CPU
    t = time.time()
    host = on_device(params, "cpu")
    want = encode(host, {"tokens": docs[:RAG_CPU_DOCS]}, cfg, env).numpy()
    cos = (want * vectors[:RAG_CPU_DOCS]).sum(axis=1)
    log("rag_host_encode", docs=RAG_CPU_DOCS, s=time.time() - t,
        min_cos=float(cos.min()), mean_cos=float(cos.mean()))
    check(float(cos.min()) >= RAG_COS, f"rag: card vs host embedding cosine "
                                       f"{float(cos.min()):.5f} < {RAG_COS}")
    del host

    rng = np.random.default_rng(0)
    ds, svc = serve_corpus("rag", vectors, rng, dev, card, log)

    retr = EncodedRetriever(cfg, env, params, svc)
    prompts = TokenPipeline(cfg.vocab_size, RAG_Q, RAG_LEN,
                            seed=1).get_batch(0)["tokens"]
    preds = rag_predicates(rng, RAG_Q)
    times = first_batch("rag/q64", retr, prompts, preds, dev, log)

    # retrieve_batch against embed_tokens + query_batch, in turns (A B B A
    # ...), so the host-bound search's drift lands on both sides alike;
    # each turn's two answers must be the same ids
    incl, embed, excl = [], [], []
    for rep in range(RAG_TIMED):
        for whole in ((True, False) if rep % 2 == 0 else (False, True)):
            t = time.time()
            if whole:
                ids, stats = retr.retrieve_batch(prompts, preds)
                incl.append((time.time() - t) * 1e3)
                continue
            q_vecs = retr.embed_tokens(prompts)
            embed.append((time.time() - t) * 1e3)
            t = time.time()
            ids_q, _ = svc.query_batch(q_vecs, preds)
            excl.append((time.time() - t) * 1e3)
        check(all(np.array_equal(a, b) for a, b in zip(ids, ids_q)),
              "rag: retrieve_batch ids differ from query_batch on "
              "embed_tokens")
    queries = [Query(vector=v, predicate=p) for v, p in zip(q_vecs, preds)]
    gt, masks = ground_truth(ds, queries, dev)
    check_results("rag/q64", ids, masks)
    lm_mesh.run(lambda: rag_mesh(cfg, params, svc, prompts, preds, ids, dev,
                                 card, log))
    sels = masks.mean(axis=1)
    recs = np.array([recall_at_k(r, g) for r, g in zip(ids, gt)])
    thirds = np.arange(RAG_Q) * 3 // RAG_Q
    log("rag_retrieve_batch", Q=RAG_Q, runs=RAG_TIMED,
        ms_incl_encode=float(np.median(incl)),
        ms_excl_encode=float(np.median(excl)),
        embed_ms=float(np.median(embed)), ms_incl_encode_runs=incl,
        ms_excl_encode_runs=excl, embed_ms_runs=embed,
        recall_at_10=float(recs.mean()),
        recall_by_sel=[float(recs[thirds == i].mean()) for i in range(3)],
        sel_by_third=[float(sels[thirds == i].mean()) for i in range(3)],
        walks=float(stats["walks"].mean()), syncs=stats["syncs"], card=card)

    # the sequential host path: RAG_SEQ prompts under the first predicate
    t = time.time()
    seq = retr.retrieve(prompts[:RAG_SEQ], preds[0])
    seq_ms = (time.time() - t) * 1e3
    check_results("rag/sequential", [r[0] for r in seq],
                  [masks[0]] * RAG_SEQ)
    gt0, _ = ground_truth(ds, [Query(vector=v, predicate=preds[0])
                               for v in q_vecs[:RAG_SEQ]], dev)
    log("rag_retrieve_sequential", Q=RAG_SEQ, ms_per_query=seq_ms / RAG_SEQ,
        recall_at_10=float(np.mean([recall_at_k(r[0], g)
                                    for r, g in zip(seq, gt0)])),
        selectivity=float(masks[0].mean()), device="host", card=card)
    del svc, retr
    torch.cuda.empty_cache()

    # generation: launch/serve.py's defaults, greedy
    eng = ServeEngine(cfg, env, params, device=dev)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    first = eng.generate(toks, max_new=GEN_NEW)  # warm-up
    torch.cuda.synchronize()
    t = time.time()
    out = eng.generate(toks, max_new=GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    logits, _ = prefill(params, {"tokens": toks}, cfg, env)
    check(out.shape == (GEN_BATCH, GEN_NEW) and torch.equal(first, out),
          "rag: greedy generate differs between two calls")
    check(bool((out < cfg.vocab_size).all()), "rag: generated a pad id")
    check(torch.equal(out[:, 0], logits[:, -1].argmax(dim=-1).to(out.dtype)),
          "rag: first generated token is not the prefill's argmax")
    log("rag_generate", batch=GEN_BATCH, prompt=GEN_PROMPT, new=GEN_NEW,
        s=gen_s, tokens_per_s=GEN_BATCH * GEN_NEW / gen_s, card=card)
    launches = path_launches("rag", SEARCH_KERNELS, log)
    log("rag_path", s=time.time() - t_path, kernel_times=times)
    return launches


# the lm_families path: the moe, hybrid and ssm LMs at their published
# widths, and hymba's embeddings feeding the fused filtered search
LM_FAMILIES = (("dbrx-132b", 4),      # 4 of 40 layers: ~57 GB of fp32
               ("hymba-1.5b", None),  # masters fit the card's 80 GB
               ("rwkv6-3b", None))
FAM_DECODE = 4          # decode steps held to the card's longer prefill
FAM_HOST_LEN = 16       # tokens of the prompt prefilled on card and host
FAM_HOST_LAYERS = {"dbrx-132b": 1}   # its host copy at one layer
# Logits held within these shares of the largest logit, for each family:
# bf16 decode vs the longer prefill, bf16 card vs host prefill, and fp32
# both. Each is about twice the largest reading on the H100 (PERF.md
# section 6). A decode step and a longer prefill (or the card and the
# host) round differently, and deep random-weight models amplify it:
# beside these the path logs the card's own bf16 prefill against its fp32
# one (``bf16_vs_fp32_rel_err``) and how far one fp32 ulp on the prompt's
# embeddings moves the fp32 logits (``fp32_ulp_rel_err``). rwkv6's 32
# layers amplify most, in fp32 too.
FAM_TOL = {"dbrx-132b": dict(decode=0.035, host=0.015, fp32=1e-3),
           "hymba-1.5b": dict(decode=0.11, host=0.10, fp32=1e-3),
           "rwkv6-3b": dict(decode=0.12, host=0.45, fp32=6e-3)}
RING_LAYERS = 4         # hymba's layers the wrapped-ring check decodes
HYMBA_DOCS = 16_384     # documents hymba encodes and the service indexes
HYMBA_BATCH = 128       # documents an encode call


def logit_rel_err(want, got) -> float:
    """Max abs difference of two (B, 1, V_pad) logits over the real
    vocabulary (pad ids are -1e30 in both), over the largest real logit
    magnitude of ``want``."""
    import torch
    want, got = want.float().cpu(), got.float().cpu()
    real = want > -1e29
    check(torch.equal(real, got > -1e29), "logits: pad ids differ")
    return float((want - got)[real].abs().max() / want[real].abs().max())


def kernel_count(prof) -> int:
    """Kernels a ``torch.profiler`` trace launched on the card."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


class Fp32:
    """While open, the port's LM passes compute in fp32: ``CDT`` set to
    float32 in ``models.common`` and ``models.transformer``, as the CPU
    parity tests run it (products then fp32 on the card too: TF32 is
    off, ``repro_torch/__init__.py``)."""

    def __enter__(self):
        import torch
        from repro_torch.models import common, transformer
        self.saved = common.CDT, transformer.CDT
        common.CDT = transformer.CDT = torch.float32

    def __exit__(self, *exc):
        from repro_torch.models import common, transformer
        common.CDT, transformer.CDT = self.saved


class Routes:
    """While open, ``models.moe._route`` keeps the expert ids of every
    call (where they were made, in call order; no copy, so no kernel) and
    passes each call through."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, self.ids = moe._route, []

        def route(x, w, dims):
            ids, weights = self.real(x, w, dims)
            self.ids.append(ids)
            return ids, weights

        moe._route = route
        return self.ids

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real


def same_routes(r_dec, r_full, B: int):
    """(B,) bool: the rows whose decode step chose, in every MoE layer, the
    experts the longer prefill chose for its last token (all True where no
    layer routes)."""
    import torch
    same = torch.ones(B, dtype=torch.bool)
    for a, b in zip(r_dec, r_full):
        last = b.cpu().reshape(B, -1, b.shape[-1])[:, -1]
        same &= (a.cpu().sort(-1).values == last.sort(-1).values).all(-1)
    return same


def decode_vs_prefill(cfg, params, toks, env):
    """FAM_DECODE ``decode_step``s after a ``prefill`` of all but the last
    FAM_DECODE columns of ``toks`` (with room for them), each held to the
    ``prefill`` over the tokens so far: their errors as shares of the
    largest logit (``logit_rel_err``) over the rows whose experts agree
    (``same_routes``: one flipped choice among near-tied router logits
    changes a row's output outright), the share of rows so held, the
    kernels the first step launched (a ``torch.profiler`` trace), the
    last prefill's logits and the cache after the last step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step, prefill
    B, S = toks.shape[0], toks.shape[1] - FAM_DECODE
    _, cache = prefill(params, {"tokens": toks[:, :S]}, cfg, env,
                       cache_len=S + FAM_DECODE)
    errs, held = [], []
    for t in range(FAM_DECODE):
        step = {"tokens": toks[:, S + t:S + t + 1]}
        with Routes() as r_dec:
            if t == 0:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    l_dec, cache = decode_step(params, cache, step, cfg, env)
                    torch.cuda.synchronize()
            else:
                l_dec, cache = decode_step(params, cache, step, cfg, env)
        with Routes() as r_full:
            l_full, _ = prefill(params, {"tokens": toks[:, :S + t + 1]},
                                cfg, env)
        rows = same_routes(r_dec, r_full, B)
        check(bool(rows.any()), f"{cfg.name}: every row's experts differ "
                                f"between decode step {t} and prefill")
        errs.append(logit_rel_err(l_full.cpu()[rows], l_dec.cpu()[rows]))
        held.append(float(rows.float().mean()))
    return errs, sum(held) / len(held), kernel_count(prof), l_full, cache


def first_layers(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers, and an
    encoder's to its first ``n`` (views of the same tensors; None: as
    they are)."""
    import dataclasses
    if n is None:
        return cfg, params
    tree = params.tree()
    tree["layers"] = tree["layers"][:n]
    cut = dict(n_layers=min(n, cfg.n_layers))
    if cfg.n_enc_layers:
        tree["enc_layers"] = tree["enc_layers"][:n]
        cut["n_enc_layers"] = min(n, cfg.n_enc_layers)
    return dataclasses.replace(cfg, **cut), params.with_tree(tree)


def wrapped_ring(cfg, params, env) -> dict:
    """A hybrid's decode through its ring, in fp32, on its first
    RING_LAYERS layers (the same weights): a prompt as long as the window
    W, with room for W more tokens (so the ring has W slots), then W
    ``decode_step``s, each writing at ``pos % W``, until every slot is
    overwritten; the last step's logits held to ``prefill`` over all 2W
    tokens within its fp32 FAM_TOL (2W: every slot overwritten once)."""
    import numpy as np

    from repro_torch.models.transformer import decode_step, prefill
    cfg, params = first_layers(cfg, params, RING_LAYERS)
    W = cfg.sliding_window
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 2 * W)).astype(np.int32)
    t = time.time()
    with Fp32():
        _, cache = prefill(params, {"tokens": toks[:, :W]}, cfg, env,
                           cache_len=2 * W)
        check(cache["k"].shape[2] == W, f"{cfg.name}: the ring has "
                                        f"{cache['k'].shape[2]} slots, not {W}")
        for p in range(W, 2 * W):
            l_dec, cache = decode_step(params, cache,
                                       {"tokens": toks[:, p:p + 1]}, cfg, env)
        l_full, _ = prefill(params, {"tokens": toks}, cfg, env)
    err = logit_rel_err(l_full, l_dec)
    check(err <= FAM_TOL[cfg.name]["fp32"], f"{cfg.name}: fp32 decode "
          f"through a wrapped ring vs prefill logits {err:.2e} of the max")
    return dict(ring_slots=W, ring_decode_steps=W, ring_layers=RING_LAYERS,
                ring_fp32_rel_err=err, ring_s=time.time() - t)


def family_checks(cfg, params, dev, card, log) -> None:
    """One LM on the card at the width it has: ``prefill`` of GEN_BATCH x
    GEN_PROMPT tokens (finite logits); greedy ``ServeEngine.generate`` of
    GEN_NEW tokens, equal in two calls, the first token the prefill's
    argmax; ``decode_vs_prefill`` (a MoE at a dropless capacity factor,
    E / k: decode is dropless) in bf16 and in fp32 within the family's
    FAM_TOL, and the card's bf16 prefill against its fp32 one logged;
    for a hybrid, ``wrapped_ring``; and the kernels one decode step
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.transformer import ShardEnv, prefill
    from repro_torch.serve.engine import ServeEngine
    env, B, S = ShardEnv(None), GEN_BATCH, GEN_PROMPT
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + FAM_DECODE)).astype(np.int32)
    prompt = {"tokens": toks[:, :S]}
    prefill(params, prompt, cfg, env)   # warm-up
    torch.cuda.synchronize()
    t = time.time()
    logits, _ = prefill(params, prompt, cfg, env)
    torch.cuda.synchronize()
    prefill_ms = (time.time() - t) * 1e3
    real = logits[..., :cfg.vocab_size]
    check(logits.shape[:2] == (B, 1) and bool(torch.isfinite(real).all()),
          f"{cfg.name}: prefill logits")

    eng = ServeEngine(cfg, env, params, device=dev)
    first = eng.generate(toks[:, :S], max_new=GEN_NEW)   # warm-up
    torch.cuda.synchronize()
    t = time.time()
    out = eng.generate(toks[:, :S], max_new=GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.time() - t
    check(out.shape == (B, GEN_NEW) and torch.equal(first, out),
          f"{cfg.name}: greedy generate differs between two calls")
    check(bool((out < cfg.vocab_size).all()), f"{cfg.name}: a pad id")
    check(torch.equal(out[:, 0], logits[:, -1].argmax(dim=-1).to(out.dtype)),
          f"{cfg.name}: first generated token is not the prefill's argmax")

    dcfg = (dataclasses.replace(cfg,
                                capacity_factor=cfg.n_experts / cfg.moe_top_k)
            if cfg.is_moe else cfg)
    tol = FAM_TOL[cfg.name]
    errs, rows, launches, l_bf16, _ = decode_vs_prefill(dcfg, params, toks,
                                                        env)
    check(max(errs) <= tol["decode"], f"{cfg.name}: bf16 decode vs "
          f"prefill logits {max(errs):.4f} of the max")
    with Fp32():
        errs32, rows32, _, l_fp32, _ = decode_vs_prefill(dcfg, params, toks,
                                                         env)
    check(max(errs32) <= tol["fp32"], f"{cfg.name}: fp32 decode vs prefill "
                                      f"logits {max(errs32):.2e} of the max")
    drift = logit_rel_err(l_fp32, l_bf16)
    ring = wrapped_ring(cfg, params, env) if cfg.family == "hybrid" else {}
    n_params = sum(p.numel() for p in params.parameters())
    log("lm_families_model", arch=cfg.name, family=cfg.family,
        layers=cfg.n_layers, d=cfg.d_model, params=n_params,
        params_gb=n_params * 4 / 1e9,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        prefill_ms=prefill_ms, prefill_tokens=B * S,
        generate_s=gen_s, tokens_per_s=B * GEN_NEW / gen_s,
        decode_step_kernels=launches, decode_rel_err=errs,
        decode_tol=tol["decode"], decode_rows_same_experts=rows,
        decode_fp32_rel_err=errs32,
        decode_fp32_tol=tol["fp32"], decode_fp32_rows_same_experts=rows32,
        bf16_vs_fp32_rel_err=drift, **ring, card=card)


def ulp_moved(cfg, params, batch, env, base) -> float:
    """How far the fp32 ``prefill`` logits ``base`` move, as a share of the
    largest, when each embedding value of the prompt's tokens is scaled by
    1 +- 2^-23 (one fp32 ulp, random signs): the scale at which this
    model carries fp32 rounding through its layers."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import prefill
    ids = torch.as_tensor(np.unique(batch["tokens"]), device=params.device)
    rows = params.embed.detach()[ids].clone()
    g = torch.Generator(device=params.device).manual_seed(3)
    sign = torch.randint(0, 2, rows.shape, generator=g,
                         device=params.device) * 2 - 1
    with torch.no_grad():
        params.embed[ids] = rows * (1 + sign * 2.0 ** -23)
        try:
            moved = logit_rel_err(base, prefill(params, batch, cfg, env)[0])
        finally:
            params.embed[ids] = rows
    return moved


def host_check(cfg, params, log) -> None:
    """The card's ``prefill`` logits of one FAM_HOST_LEN-token prompt held
    to the port's on the host with the same weights, in bf16 and in fp32
    within the family's FAM_TOL (with, for a MoE, the share of routing
    decisions (token, choice) that agree logged, and ``ulp_moved`` of the
    card's fp32 logits)."""
    import numpy as np

    from repro_torch.models.transformer import ShardEnv, on_device, prefill
    env, tol = ShardEnv(None), FAM_TOL[cfg.name]
    one = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, FAM_HOST_LEN)).astype(np.int32)}
    t = time.time()
    host = on_device(params, "cpu")
    with Routes() as routes:
        l_card, _ = prefill(params, one, cfg, env)
        n_card = len(routes)
        l_host, _ = prefill(host, one, cfg, env)
    err = logit_rel_err(l_host, l_card)
    share = (float(np.mean([(a.cpu() == b).float().mean().item() for a, b
                            in zip(routes[:n_card], routes[n_card:])]))
             if routes else None)
    with Fp32():
        l32 = prefill(params, one, cfg, env)[0]
        err32 = logit_rel_err(prefill(host, one, cfg, env)[0], l32)
        ulp = ulp_moved(cfg, params, one, env, l32)
    del host
    log("lm_families_host", arch=cfg.name, layers=cfg.n_layers,
        tokens=FAM_HOST_LEN, rel_err=err, tol=tol["host"],
        routing_share_equal=share, fp32_rel_err=err32, fp32_tol=tol["fp32"],
        fp32_ulp_rel_err=ulp, s=time.time() - t)
    check(err32 <= tol["fp32"], f"{cfg.name}: fp32 card vs host prefill "
                                f"logits {err32:.2e} of the max")
    check(err <= tol["host"], f"{cfg.name}: bf16 card vs host prefill "
                              f"logits {err:.4f} of the max")


def hymba_retrieval(cfg, params, dev, card, log, fmesh=None) -> None:
    """Hymba's embeddings through the fused filtered search at d = 1,600:
    HYMBA_DOCS documents encoded on the card, RAG_FIELDS fields, served
    at k=K (``serve_corpus``); ``EncodedRetriever.retrieve_batch`` on
    RAG_Q prompts with the rag path's three selectivities, its first
    K1, K3 and walk_round calls held to their plain versions and
    walk_round, K2 and K3 timed on them (``first_batch``), its ids equal
    to ``embed_tokens`` +
    ``query_batch``, passing their predicates, recall@K against exact
    filtered top-k; then, in ``fmesh``, the prompts encoded over a mesh
    for the same service (``hymba_mesh_retrieval``)."""
    import numpy as np
    import torch

    from repro_torch.core.types import Query
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import ShardEnv
    from repro_torch.serve.retrieval import EncodedRetriever
    env = ShardEnv(None)
    _, vectors, enc_s = encode_corpus("lm_families", cfg, params, env,
                                      HYMBA_DOCS, HYMBA_BATCH, dev)
    log("lm_families_encode", arch=cfg.name, docs=HYMBA_DOCS, tokens=RAG_LEN,
        batch=HYMBA_BATCH, s=enc_s, docs_per_s=HYMBA_DOCS / enc_s,
        card=card)
    rng = np.random.default_rng(0)
    ds, svc = serve_corpus("lm_families", vectors, rng, dev, card, log)
    retr = EncodedRetriever(cfg, env, params, svc)
    prompts = TokenPipeline(cfg.vocab_size, RAG_Q, RAG_LEN,
                            seed=1).get_batch(0)["tokens"]
    preds = rag_predicates(rng, RAG_Q)
    times = first_batch("lm_families/hymba_q64", retr, prompts, preds, dev,
                        log)
    torch.cuda.synchronize()
    t = time.time()
    ids, stats = retr.retrieve_batch(prompts, preds)
    ms = (time.time() - t) * 1e3
    q_vecs = retr.embed_tokens(prompts)
    ids_q, _ = svc.query_batch(q_vecs, preds)
    check(all(np.array_equal(a, b) for a, b in zip(ids, ids_q)),
          "lm_families: retrieve_batch ids differ from query_batch on "
          "embed_tokens")
    gt, masks = ground_truth(
        ds, [Query(vector=v, predicate=p) for v, p in zip(q_vecs, preds)],
        dev)
    check_results("lm_families/hymba_q64", ids, masks)
    recs = np.array([recall_at_k(r, g) for r, g in zip(ids, gt)])
    thirds = np.arange(RAG_Q) * 3 // RAG_Q
    log("lm_families_retrieve_batch", arch=cfg.name, Q=RAG_Q, ms=ms,
        recall_at_10=float(recs.mean()),
        recall_by_sel=[float(recs[thirds == i].mean()) for i in range(3)],
        walks=float(stats["walks"].mean()), syncs=stats["syncs"],
        kernel_times=times, card=card)
    if fmesh is not None:
        fmesh.run(lambda: hymba_mesh_retrieval(cfg, params, svc, prompts,
                                               preds, ids, dev, card, log))
    del svc, retr


def lm_families_path(dev, card, log, fmesh=None) -> dict:
    """The moe, hybrid and ssm LMs on the card (LM_FAMILIES; random
    weights from ``init_params`` with seed 0), one at a time, each freed
    before the next: ``family_checks``, in ``fmesh`` (a ``Segments``) the
    arch's ``family_mesh`` cases on the same weights, for hymba its
    retrieval (``hymba_retrieval``), then ``host_check`` (dbrx at one
    layer, FAM_HOST_LAYERS: its host copy of four would take 57 GB).
    Returns the path's launch counts."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params
    t_path = time.time()
    build.LAUNCHES.clear()
    for name, layers in LM_FAMILIES:
        t = time.time()
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device=dev)
        family_checks(cfg, params, dev, card, log)
        if fmesh is not None and name in FMESH_ARCHS:
            fmesh.run(lambda: family_mesh(cfg, params, dev, card, log))
        if cfg.family == "hybrid":
            hymba_retrieval(cfg, params, dev, card, log, fmesh)
        if name in FAM_HOST_LAYERS:
            del params
            torch.cuda.empty_cache()
            cfg = dataclasses.replace(cfg, n_layers=FAM_HOST_LAYERS[name])
            params = init_params(cfg, seed=0, device=dev)
        host_check(cfg, params, log)
        del params
        log("lm_families_arch", arch=name, s=time.time() - t)
    torch.cuda.empty_cache()
    launches = path_launches("lm_families", SEARCH_KERNELS, log)
    log("lm_families_path", s=time.time() - t_path)
    return launches


# -- the LM over a device mesh ---------------------------------------------------

MESH_ARCH = "llama3.2-1b"
MESH_SHAPE = (2, 4)       # data x model cells, every one on the card
MESH_BATCH, MESH_PROMPT, MESH_NEW = 8, 512, 32
MESH_MEM = 1.1            # memory after placing, over the parameters'
MOE_ARCH, MOE_LAYERS = "dbrx-132b", 2   # 2 of 40 layers: ~30 GB of fp32
MOE_SHAPE = (1, 4)        # 16 experts, 4 a model cell
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 4, 256, 4
MOE_HOST_LEN = 16         # prompt tokens the card and host meshes run
FLASH_HEADS, FLASH_KV, FLASH_HD = 32, 8, 64   # llama3.2-1b's attention
FLASH_S, FLASH_LEN = 32_768, 20_000           # cache slots, valid ones
FLASH_SHAPE = (1, 8)
FLASH_TOL = 1e-4          # fp32, absolute
RAG_MESH_SHAPE = (1, 3)   # SmolLM's 9 / 3 heads, d_ff, vocab in thirds
RAG_MESH_OVERLAP = 0.98
# Logits over a mesh against the meshless pass with the same weights, as
# shares of the largest logit: bf16 (the summation splits differ: each
# model cell's partial product is rounded to bf16 before the sum) and
# fp32; about twice the H100's readings (0.0182 and 4.6e-6, PERF.md
# section 6).
MESH_TOL = dict(bf16=0.04, fp32=1e-5)


class CellRoutes:
    """While open, ``models.moe._route`` keeps each call's expert ids by
    the mesh cell that made them (``placement.current_cell()``), in the
    cell's call order (its layers, in order), and passes each call
    through."""

    def __enter__(self):
        from repro_torch.launch.placement import current_cell
        from repro_torch.models import moe
        self.real, self.ids = moe._route, {}

        def route(x, w, dims):
            ids, weights = self.real(x, w, dims)
            self.ids.setdefault(current_cell().index, []).append(ids)
            return ids, weights

        moe._route = route
        return self.ids

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.real


def same_cell_routes(a: dict, b: dict, B: int):
    """(B,) bool: the batch rows whose every token chose the same experts
    in every routing call of two runs on meshes of one shape (``CellRoutes``
    of each; a call's tokens are its cell's block of the batch, rows
    major)."""
    import torch
    same = torch.ones(B, dtype=torch.bool)
    n_data = 1 + max(idx[0] for idx in a)
    b_loc = B // n_data
    for idx, calls in a.items():
        for x, y in zip(calls, b[idx]):
            agree = (x.cpu().sort(-1).values
                     == y.cpu().sort(-1).values).all(-1)
            rows = agree.reshape(b_loc, -1).all(-1)
            same[idx[0] * b_loc:(idx[0] + 1) * b_loc] &= rows
    return same


def a2a_drops(routes: dict, E: int, cf: float) -> tuple[int, int]:
    """(dropped, all) (token, choice) rows of the expert-parallel
    capacity path on a 1 x n mesh, from each cell's expert ids
    (``CellRoutes`` of one prefill): cell j keeps the first ``cap_s``
    rows bound for each expert cell, and expert cell m the first
    ``cap_e`` rows it received for each of its experts, as
    ``moe._a2a_local`` deals them."""
    import torch
    n = len(routes)
    E_loc = E // n
    dropped = total = 0
    for layer in range(len(routes[0, 0])):
        flat = [routes[0, j][layer].reshape(-1).cpu() for j in range(n)]
        cap_s = int((flat[0].numel() // n) * cf) + 1
        cap_e = int(n * cap_s // E_loc * cf) + 1
        for m in range(n):
            got = torch.cat([f[f // E_loc == m][:cap_s] for f in flat])
            kept = torch.bincount(got - m * E_loc, minlength=E_loc)
            dropped -= int(kept.clamp(max=cap_e).sum())
        total += sum(f.numel() for f in flat)
    return dropped + total, total


def timed_ms(fn):
    """``fn()``'s result and its milliseconds, the card synchronized
    after it."""
    import torch
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t) * 1e3


def step_kernels(fn) -> int:
    """Kernels one call of ``fn`` launched on the card (a profiler
    trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_count(prof)


def llama_mesh(dev, card, log) -> None:
    """llama3.2-1b at its published widths (16 layers, d 2048, 32 / 8
    heads, d_ff 8,192, vocab 128,256; random weights from ``init_params``
    with seed 0) on a 2 x 4 data x model mesh of cells on the card,
    policy tp: placing the parameters takes at most MESH_MEM x their
    memory (views); the mesh prefill of MESH_BATCH x MESH_PROMPT tokens
    held to the meshless one on the same parameters in bf16 and fp32
    (MESH_TOL); ``ServeEngine.generate`` of MESH_NEW greedy tokens over
    the mesh, each of them teacher-forced through the meshless model's
    decode and scored there within the bf16 tolerance of its best logit;
    ms a prefill, tokens/s and kernels a decode step, mesh and
    meshless."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import (ShardEnv, decode_step,
                                                init_params, place_params,
                                                prefill)
    from repro_torch.serve.engine import ServeEngine
    t0 = time.time()
    cfg = get_config(MESH_ARCH)
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    params = init_params(cfg, seed=0, device=dev)
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    env = ShardEnv(make_local_mesh(*MESH_SHAPE,
                                   devices=[dev] * int(np.prod(MESH_SHAPE))))
    placed = place_params(params, env)
    placed_mem = torch.cuda.memory_allocated() - m0
    check(placed_mem <= MESH_MEM * p_bytes,
          f"lm_mesh: {placed_mem} bytes after placing {p_bytes} bytes of "
          f"parameters")
    one = ShardEnv(None)
    prompt = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)}
    rec = {}
    for name, p, e in (("meshless", params, one), ("mesh", placed, env)):
        prefill(p, prompt, cfg, e)    # warm-up
        torch.cuda.synchronize()
        (rec[name], _), rec[name + "_prefill_ms"] = timed_ms(
            lambda: prefill(p, prompt, cfg, e))
    err = logit_rel_err(rec["meshless"], rec["mesh"])
    check(err <= MESH_TOL["bf16"], f"lm_mesh: bf16 mesh vs meshless "
                                   f"prefill logits {err:.4f} of the max")
    with Fp32():
        err32 = logit_rel_err(prefill(params, prompt, cfg, one)[0],
                              prefill(placed, prompt, cfg, env)[0])
    check(err32 <= MESH_TOL["fp32"], f"lm_mesh: fp32 mesh vs meshless "
                                     f"prefill logits {err32:.2e} of the max")

    eng = ServeEngine(cfg, env, placed)
    out, gen_ms = timed_ms(lambda: eng.generate(prompt["tokens"],
                                                max_new=MESH_NEW))
    eng1 = ServeEngine(cfg, one, params, device=dev)
    out1, gen1_ms = timed_ms(lambda: eng1.generate(prompt["tokens"],
                                                   max_new=MESH_NEW))
    check(out.shape == (MESH_BATCH, MESH_NEW)
          and bool((out < cfg.vocab_size).all()), "lm_mesh: generated ids")
    # the meshless model fed the mesh's tokens: each within the bf16
    # tolerance of that step's best logit
    logits, cache = prefill(params, prompt, cfg, one,
                            cache_len=MESH_PROMPT + MESH_NEW)
    gaps = []
    for t in range(MESH_NEW):
        last = logits[:, -1].float()
        best = last.max(dim=-1).values
        chose = last.gather(1, out[:, t:t + 1].long())[:, 0]
        gaps.append(float(((best - chose) / last.abs().max()).max()))
        if t + 1 < MESH_NEW:
            logits, cache = decode_step(params, cache,
                                        {"tokens": out[:, t:t + 1]}, cfg,
                                        one)
    check(max(gaps) <= MESH_TOL["bf16"], f"lm_mesh: a mesh token "
          f"{max(gaps):.4f} of the max below the meshless best")
    _, cache = prefill(placed, prompt, cfg, env, cache_len=MESH_PROMPT + 1)
    _, cache1 = prefill(params, prompt, cfg, one, cache_len=MESH_PROMPT + 1)
    step = {"tokens": out[:, :1]}
    k_mesh = step_kernels(lambda: decode_step(placed, cache, step, cfg, env))
    k_one = step_kernels(lambda: decode_step(params, cache1, step, cfg, one))
    log("lm_mesh_llama", arch=cfg.name, mesh=list(MESH_SHAPE), policy="tp",
        layers=cfg.n_layers, d=cfg.d_model, params_gb=p_bytes / 1e9,
        placed_over_params=placed_mem / p_bytes,
        prefill_tokens=MESH_BATCH * MESH_PROMPT,
        prefill_ms=rec["mesh_prefill_ms"],
        meshless_prefill_ms=rec["meshless_prefill_ms"],
        prefill_rel_err=err, prefill_fp32_rel_err=err32,
        tol=MESH_TOL, new=MESH_NEW,
        tokens_per_s=MESH_BATCH * MESH_NEW / (gen_ms / 1e3),
        meshless_tokens_per_s=MESH_BATCH * MESH_NEW / (gen1_ms / 1e3),
        tokens_equal_share=float((out == out1).float().mean()),
        teacher_forced_max_gap=max(gaps),
        decode_step_kernels=k_mesh, meshless_decode_step_kernels=k_one,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        generate_s=gen_ms / 1e3, s=time.time() - t0, card=card)


def dbrx_mesh(dev, card, log) -> None:
    """dbrx-132b at its published widths with MOE_LAYERS of its 40 layers
    on a 1 x 4 mesh of cells on the card (16 experts, 4 a cell): a
    prefill of MOE_BATCH x MOE_PROMPT through the expert-parallel
    capacity path (``_moe_a2a``; the (token, choice) rows it drops
    logged) and MOE_DECODE decode steps through the dropless one
    (``_moe_replicated``), finite; then, at one layer, the card mesh's
    prefill of a MOE_HOST_LEN-token prompt and two decode steps held to
    the same 1 x 4 mesh of host cells with the same weights, on the rows
    whose experts agree in every call (``same_cell_routes``; at least
    half of them), in fp32 and in bf16 within dbrx's FAM_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import (ShardEnv, decode_step,
                                                init_params, on_device,
                                                place_params, prefill)
    t0 = time.time()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    cells = int(np.prod(MOE_SHAPE))
    env = ShardEnv(make_local_mesh(*MOE_SHAPE, devices=[dev] * cells))
    torch.cuda.empty_cache()
    params = place_params(init_params(cfg, seed=0, device=dev), env)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT + MOE_DECODE)
    ).astype(np.int32)
    prompt = {"tokens": toks[:, :MOE_PROMPT]}
    prefill(params, prompt, cfg, env)   # warm-up
    torch.cuda.synchronize()
    with CellRoutes() as routes:
        (logits, cache), prefill_ms = timed_ms(lambda: prefill(
            params, prompt, cfg, env, cache_len=MOE_PROMPT + MOE_DECODE))
    dropped, rows = a2a_drops(routes, cfg.n_experts, cfg.capacity_factor)
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          "lm_mesh: dbrx mesh prefill logits")
    dec_ms = []
    for t in range(MOE_DECODE):
        (logits, cache), ms = timed_ms(lambda: decode_step(
            params, cache, {"tokens": toks[:, MOE_PROMPT + t:][:, :1]}, cfg,
            env))
        dec_ms.append(ms)
        check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
              f"lm_mesh: dbrx mesh decode step {t} logits")
    del params, cache, logits
    torch.cuda.empty_cache()

    t_host = time.time()
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    card1 = init_params(cfg1, seed=0, device=dev)
    host_env = ShardEnv(make_local_mesh(*MOE_SHAPE, devices=["cpu"] * cells))
    card1, host = (place_params(card1, env),
                   place_params(on_device(card1, "cpu"), host_env))
    short = toks[:, :MOE_HOST_LEN + 2]
    errs = {}
    for mode in ("fp32", "bf16"):
        runs = []
        with (Fp32() if mode == "fp32" else contextlib.nullcontext()):
            for p, e in ((card1, env), (host, host_env)):
                out = []
                with CellRoutes() as r:
                    lg, c = prefill(p, {"tokens": short[:, :MOE_HOST_LEN]},
                                    cfg1, e, cache_len=MOE_HOST_LEN + 2)
                    out.append(lg.cpu())
                    for t in range(2):
                        lg, c = decode_step(p, c, {"tokens": short[
                            :, MOE_HOST_LEN + t:MOE_HOST_LEN + t + 1]},
                            cfg1, e)
                        out.append(lg.cpu())
                runs.append((out, r))
        (card_out, rc), (host_out, rh) = runs
        same = same_cell_routes(rc, rh, MOE_BATCH)
        check(int(same.sum()) >= MOE_BATCH // 2,
              f"lm_mesh: dbrx {mode}: {int(same.sum())} of {MOE_BATCH} "
              f"rows' experts agree between card and host")
        errs[mode] = [logit_rel_err(h[same], g[same])
                      for h, g in zip(host_out, card_out)]
        errs[mode + "_rows_same_experts"] = float(same.float().mean())
    tol = FAM_TOL[MOE_ARCH]
    check(max(errs["fp32"]) <= tol["fp32"], f"lm_mesh: dbrx fp32 card vs "
          f"host mesh logits {max(errs['fp32']):.2e} of the max")
    check(max(errs["bf16"]) <= tol["host"], f"lm_mesh: dbrx bf16 card vs "
          f"host mesh logits {max(errs['bf16']):.4f} of the max")
    log("lm_mesh_dbrx", arch=cfg.name, mesh=list(MOE_SHAPE),
        layers=cfg.n_layers, experts=cfg.n_experts,
        prefill_tokens=MOE_BATCH * MOE_PROMPT, prefill_ms=prefill_ms,
        dropped_choices=dropped, choices=rows,
        dropped_share=dropped / rows, decode_ms=dec_ms,
        host_layers=1, host_tokens=MOE_HOST_LEN,
        host_rel_err=errs, host_tol=tol, host_s=time.time() - t_host,
        s=time.time() - t0, card=card)


def flash_mesh(dev, card, log) -> None:
    """``flash_decode_sharded`` at llama3.2-1b's attention widths (B = 1,
    32 / 8 heads, hd 64) over a FLASH_S-slot cache, FLASH_LEN of them
    valid, split over a 1 x 8 mesh of cells on the card: within FLASH_TOL
    of ``decode_attention`` in fp32; both timed."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.attention import (decode_attention,
                                              flash_decode_sharded)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 1, FLASH_HEADS, FLASH_HD), generator=g, device=dev)
    k, v = (torch.randn((1, FLASH_S, FLASH_KV, FLASH_HD), generator=g,
                        device=dev) for _ in range(2))
    mesh = make_local_mesh(*FLASH_SHAPE,
                           devices=[dev] * int(np.prod(FLASH_SHAPE)))

    def sharded():
        return flash_decode_sharded(q, k, v, FLASH_LEN, mesh=mesh,
                                    seq_axis="model")

    def plain():
        return decode_attention(q, k, v, FLASH_LEN)

    sharded(), plain()   # warm-up
    torch.cuda.synchronize()
    got, ms = timed_ms(sharded)
    want, plain_ms = timed_ms(plain)
    err = float((got - want).abs().max())
    check(err <= FLASH_TOL, f"lm_mesh: flash decode vs decode_attention "
                            f"{err:.2e}")
    log("lm_mesh_flash", mesh=list(FLASH_SHAPE), heads=FLASH_HEADS,
        kv_heads=FLASH_KV, hd=FLASH_HD, slots=FLASH_S, cache_len=FLASH_LEN,
        max_abs_err=err, ms=ms, decode_attention_ms=plain_ms, card=card)


def rag_mesh(cfg, params, svc, prompts, preds, ids, dev, card, log) -> None:
    """The rag path's prompts encoded on a 1 x 3 mesh of cells on the card
    (SmolLM-135M's 9 heads, 3 KV heads, d_ff and padded vocab split three
    ways) for the same meshless service, through ``EncodedRetriever.
    retrieve_batch`` (K1/K3/WR): in bf16, the embeddings at cosine >= RAG_COS
    to the meshless encoder's and the ids' overlap with the meshless
    run's (``ids``) logged; in fp32 (``Fp32``, both encoders), the ids
    overlapping the meshless retriever's by at least RAG_MESH_OVERLAP.
    In bf16 the two encoders round their row-parallel sums apart, and the
    walk carries a query that moved by that much to other near-tied rows
    (ids are not held there, as the card is not held to the host by ids
    but by cosine)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import ShardEnv
    from repro_torch.serve.retrieval import EncodedRetriever
    env = ShardEnv(make_local_mesh(*RAG_MESH_SHAPE, devices=[dev] * int(
        np.prod(RAG_MESH_SHAPE))))
    retr = EncodedRetriever(cfg, env, params, svc)
    one = EncodedRetriever(cfg, ShardEnv(None), params, svc)
    (got, stats), ms = timed_ms(lambda: retr.retrieve_batch(prompts, preds))
    cos = (retr.embed_tokens(prompts) * one.embed_tokens(prompts)).sum(1)
    check(float(cos.min()) >= RAG_COS, f"lm_mesh: mesh vs meshless "
                                       f"embedding cosine {cos.min():.5f}")
    with Fp32():
        got32, _ = retr.retrieve_batch(prompts, preds)
        saved = dict(build.LAUNCHES)   # the meshless run is not this path's
        want32, _ = one.retrieve_batch(prompts, preds)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
    share32 = overlap(want32, got32)
    check(share32 >= RAG_MESH_OVERLAP, f"lm_mesh: fp32 mesh-encoded "
                                       f"retrieve_batch ids overlap "
                                       f"{share32:.4f}")
    log("lm_mesh_rag", arch=cfg.name, mesh=list(RAG_MESH_SHAPE), Q=len(ids),
        ms=ms, overlap_bf16=overlap(ids, got), overlap_fp32=share32,
        exact_fp32=float(np.mean([np.array_equal(a, b)
                                  for a, b in zip(want32, got32)])),
        min_cos=float(cos.min()), walks=float(stats["walks"].mean()),
        card=card)


def lm_mesh_path(dev, card, log) -> None:
    """The LM's serving over a device mesh, every cell on the card
    (``devices=[cuda:0] * n``): ``llama_mesh``, ``dbrx_mesh`` and
    ``flash_mesh``, one after another (the rag path runs ``rag_mesh``,
    this path's K1, K3 and WR segment, on its service)."""
    import torch
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    llama_mesh(dev, card, log)
    torch.cuda.empty_cache()
    dbrx_mesh(dev, card, log)
    torch.cuda.empty_cache()
    flash_mesh(dev, card, log)
    log("lm_mesh_models", s=time.time() - t)


# -- the hybrid, ssm and audio families over a device mesh ----------------------

# (data x model cells, layers, batch, prompt tokens, decode steps) of each
# arch's cases, policy tp, every cell on the card, on the lm_families and
# whisper paths' weights (the first layers as views; None: every layer).
# Depth is cut to fit the segment's time (PERF.md section 4); the widths
# are the published ones.
FMESH_CASES = {
    "hymba-1.5b": (((2, 4), 2, 8, 128, 16),    # 25 / 5 heads replicated
                   ((1, 5), 1, 1, 1088, 8),    # split; W + 64 wraps the ring
                   ((2, 4), 1, 1, 1088, 8)),   # B = 1: the ring's slots split
    "rwkv6-3b": (((2, 4), 2, 8, 64, 16),),     # 40 heads, 10 a model cell
    "whisper-small": (((2, 4), 4, 4, 32, 16),),   # 4 + 4 layers, 4 x 1,500
}                                                # frames
FMESH_ARCHS = ("hymba-1.5b", "rwkv6-3b")   # cased inside lm_families
FMESH_RAG_SHAPE = (2, 4)   # hymba's retrieval prompts encoded on it, whole


def fmesh_case(cfg, params, shape, B, S, new, dev, card, log) -> None:
    """One family on a mesh of cells on the card, policy tp, against the
    meshless pass on the same parameters: placing costs at most MESH_MEM
    x their memory; ``prefill`` of B x S tokens (whisper: with
    WHISPER_FRAMES frames) held to the meshless one in bf16 (MESH_TOL)
    and, in fp32, within the tighter of MESH_TOL and the family's fp32
    bound, as is each of ``new`` teacher-forced fp32 ``decode_step``s to
    the meshless step; ms a prefill, tokens/s (``ServeEngine.generate``;
    whisper's own greedy loop) and kernels a decode step, mesh beside
    meshless. Where B does not divide the data axis, hymba's ring must be
    placed with its slots split over the model axis (``cache_shardings``),
    so the fp32 decode holds the flash-decode combine over a wrapped,
    sequence-split ring."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import (ShardEnv, decode_step,
                                                place_params, prefill)
    from repro_torch.serve.engine import ServeEngine
    t0 = time.time()
    audio = cfg.family == "audio"
    env, one = mesh_env(shape, "tp", dev), ShardEnv(None)
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    placed = place_params(params, env)
    placed_over = (p_bytes + torch.cuda.memory_allocated() - m0) / p_bytes
    check(placed_over <= MESH_MEM, f"family_mesh: {cfg.name} placed "
                                   f"{placed_over:.3f} x its parameters")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + new)).astype(np.int32)
    prompt = {"tokens": toks[:, :S]}
    if audio:
        prompt["frames"] = rng.standard_normal(
            (B, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)
    runs = (("meshless", params, one), ("mesh", placed, env))
    rec, caches = {}, {}
    for name, p, e in runs:
        prefill(p, prompt, cfg, e, cache_len=S + new)   # warm-up
        torch.cuda.synchronize()
        (rec[name], caches[name]), rec[name + "_prefill_ms"] = timed_ms(
            lambda: prefill(p, prompt, cfg, e, cache_len=S + new))
    err = logit_rel_err(rec["meshless"], rec["mesh"])
    check(err <= MESH_TOL["bf16"], f"family_mesh: {cfg.name} bf16 mesh vs "
                                   f"meshless prefill logits {err:.4f}")
    ring = None
    if cfg.family == "hybrid":
        ring = list(caches["mesh"]["k"].spec)
        ring_seq = len(ring) > 2 and ring[2] is not None
        check(ring_seq == (B % shape[0] != 0), f"family_mesh: {cfg.name} "
              f"ring on {shape} with B = {B} placed as {ring}")
    step = {"tokens": toks[:, S:S + 1]}
    kernels = {name: device_kernels(lambda: decode_step(
        p, caches[name], step, cfg, e)) for name, p, e in runs}
    del caches
    gen = {}
    for name, p, e in runs:
        if audio:   # no ServeEngine for a frontend arch: greedy by hand
            def greedy():
                logits, cache = prefill(p, prompt, cfg, e,
                                        cache_len=S + new)
                out = []
                for _ in range(new):
                    nxt = logits[:, -1].argmax(-1, keepdim=True).to(
                        torch.int32)
                    out.append(nxt)
                    logits, cache = decode_step(p, cache, {"tokens": nxt},
                                                cfg, e)
                return torch.cat(out, dim=1)
        else:
            eng = ServeEngine(cfg, e, p, device=None if e.mesh else dev)

            def greedy():
                return eng.generate(toks[:, :S], max_new=new)
        gen[name], gen[name + "_ms"] = timed_ms(greedy)
    bound32 = min(MESH_TOL["fp32"],
                  FAM_TOL.get(cfg.name, WHISPER_TOL)["fp32"])
    with Fp32():
        outs = {}
        for name, p, e in runs:
            logits, cache = prefill(p, prompt, cfg, e, cache_len=S + new)
            outs[name] = [logits]
            for t in range(new):
                logits, cache = decode_step(p, cache, {
                    "tokens": toks[:, S + t:S + t + 1]}, cfg, e)
                outs[name].append(logits)
            del cache
    errs32 = [logit_rel_err(a, b)
              for a, b in zip(outs["meshless"], outs["mesh"])]
    check(errs32[0] <= bound32, f"family_mesh: {cfg.name} fp32 mesh vs "
                                f"meshless prefill logits {errs32[0]:.2e}")
    check(max(errs32[1:]) <= bound32, f"family_mesh: {cfg.name} fp32 mesh "
          f"vs meshless decode logits {max(errs32[1:]):.2e}")
    log("family_mesh_case", arch=cfg.name, family=cfg.family,
        mesh=list(shape), policy="tp", layers=cfg.n_layers,
        enc_layers=cfg.n_enc_layers or None, d=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads],
        frames=WHISPER_FRAMES if audio else None,
        params_gb=p_bytes / 1e9, placed_over_params=placed_over,
        batch=B, prompt=S, new=new, ring_spec=ring,
        prefill_ms=rec["mesh_prefill_ms"],
        meshless_prefill_ms=rec["meshless_prefill_ms"],
        prefill_rel_err=err, fp32_prefill_rel_err=errs32[0],
        fp32_decode_rel_err=max(errs32[1:]), fp32_bound=bound32,
        bf16_bound=MESH_TOL["bf16"],
        tokens_per_s=B * new / (gen["mesh_ms"] / 1e3),
        meshless_tokens_per_s=B * new / (gen["meshless_ms"] / 1e3),
        tokens_equal_share=float((gen["mesh"] == gen["meshless"]).float()
                                 .mean()),
        decode_step_kernels=kernels["mesh"],
        meshless_decode_step_kernels=kernels["meshless"],
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        s=time.time() - t0, card=card)


def family_mesh(cfg, params, dev, card, log) -> None:
    """``fmesh_case`` for each of the arch's FMESH_CASES, on its first
    layers."""
    import torch
    for shape, layers, B, S, new in FMESH_CASES[cfg.name]:
        c, p = first_layers(cfg, params, layers)
        fmesh_case(c, p, shape, B, S, new, dev, card, log)
        torch.cuda.empty_cache()


def hymba_mesh_retrieval(cfg, params, svc, prompts, preds, ids, dev, card,
                         log) -> None:
    """The hymba retrieval's prompts encoded by the whole model on a
    FMESH_RAG_SHAPE mesh of cells on the card (its 25 / 5 heads
    replicated, FFN and mamba channels split) for the same meshless
    service, through ``EncodedRetriever.retrieve_batch`` (K1/K3/WR): in
    bf16 timed, its ids' overlap with the meshless run's (``ids``)
    logged; in fp32 (both encoders), the ids overlapping the meshless
    retriever's by at least RAG_MESH_OVERLAP (the meshless run's
    launches are not this segment's)."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models.transformer import ShardEnv
    from repro_torch.serve.retrieval import EncodedRetriever
    retr = EncodedRetriever(cfg, mesh_env(FMESH_RAG_SHAPE, "tp", dev),
                            params, svc)
    one = EncodedRetriever(cfg, ShardEnv(None), params, svc)
    (got, stats), ms = timed_ms(lambda: retr.retrieve_batch(prompts, preds))
    with Fp32():
        got32, _ = retr.retrieve_batch(prompts, preds)
        saved = dict(build.LAUNCHES)
        want32, _ = one.retrieve_batch(prompts, preds)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(saved)
    share32 = overlap(want32, got32)
    check(share32 >= RAG_MESH_OVERLAP, f"family_mesh: fp32 hymba "
          f"mesh-encoded retrieve_batch ids overlap {share32:.4f}")
    log("family_mesh_rag", arch=cfg.name, mesh=list(FMESH_RAG_SHAPE),
        layers=cfg.n_layers, Q=len(ids), ms=ms,
        overlap_bf16=overlap(ids, got), overlap_fp32=share32,
        exact_fp32=float(np.mean([np.array_equal(a, b)
                                  for a, b in zip(want32, got32)])),
        walks=float(stats["walks"].mean()), card=card)


# -- the training path ---------------------------------------------------------

TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 128, 3e-3   # launch/train.py's defaults
TRAIN_STEPS = 30
TRAIN_TIMED_FROM = 5      # ms a step: the median over steps 5..29
TRAIN_DESCENT = 1.0       # the last step's loss below the first by this much
RESUME_AT, RESUME_TO = 6, 12
RESUME_RTOL = 1e-4        # losses after a resume vs straight through
PREEMPT_AT = 3            # SIGUSR1 is sent during this step
# Step 0 on the card held to the same step on the host, bounds from the
# CPU tests' (tests/test_torch_train.py: fp32 loss 1e-5, each gradient
# leaf 1e-4 of its largest magnitude, bf16 loss 2e-3, at 2 layers) scaled
# by 5 >= sqrt(30 / 2) for SmolLM's 30 layers; the grad norm as a leaf.
# bf16 gradients are held as the CPU test holds them: each leaf of the
# card's no further from the host's fp32 gradient than STEP0_RATIO times
# the host's own bf16 gradient, plus STEP0_FLOOR (rounding moves whole
# one-hots of the loss's gradient, test_loss_and_grads_bf16).
STEP0_TOL = dict(loss=5e-5, gnorm=5e-4, leaf=5e-4, loss_bf16=1e-2)
STEP0_RATIO, STEP0_FLOOR = 2.5, 1e-2
WHISPER_ARCH = "whisper-small"
WHISPER_FRAMES = 1500     # a 30-s window after the (stubbed) conv frontend
WHISPER_HELD = (0, 5, 10, 15)   # decode steps held to the longer prefill
# Shares of the largest logit: bf16 decode vs the longer prefill and card
# vs host prefill, and fp32 both (FAM_TOL's fp32 bound; bf16 between its
# dbrx and hymba bounds, for 12 + 12 layers).
WHISPER_TOL = dict(decode=0.06, host=0.06, fp32=1e-3)
WHISPER_TRAIN_STEPS, WHISPER_DESCENT = 10, 0.5
# One step of each family at full width and 2 layers, held to the host's
# fp32 step with the CPU tests' bounds (loss 1e-5 scaled by the loss's
# ~11 nats over their ~6, each m leaf 1e-4 of its largest), and the
# update of the same gradients on both within 1e-3 lr (fp32 elementwise
# arithmetic: ulps of the parameter and of the clip scale).
FAMILY_STEPS = ("hymba-1.5b", "rwkv6-3b")
FAMILY_LAYERS, FAMILY_BATCH, FAMILY_SEQ = 2, 2, 128
FAMILY_TOL = dict(loss=2e-5, leaf=1e-4, update_lr=1e-3)
DBRX_LAYERS, DBRX_BATCH, DBRX_SEQ = 1, 4, 128
# dbrx's bf16 vs fp32 per-token loss on the tokens whose experts agree:
# the largest difference and the difference of their means, in nats
DBRX_TOL = dict(token=0.2, mean=0.02)


def flat_grads(tree) -> dict:
    """path -> leaf of a parameter-layout tree (``/``-joined)."""
    from repro_torch.optim.adamw import leaves_with_path
    return {"/".join(p): x for p, x in leaves_with_path(tree)}


def leaf_rel_errs(want: dict, got: dict) -> dict:
    """Each leaf's max abs difference over its largest magnitude in
    ``want``, on the host."""
    out = {}
    for k, w in want.items():
        w, g = w.detach().float().cpu(), got[k].detach().float().cpu()
        out[k] = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
    return out


def loss_and_grads(params, batch, cfg, env):
    """(loss, grad norm, path -> gradient) of ``forward_loss``."""
    from repro_torch.models.transformer import forward_loss
    from repro_torch.optim.adamw import global_norm, value_and_grad
    loss, g = value_and_grad(lambda p: forward_loss(p, batch, cfg, env),
                             params)
    return float(loss), float(global_norm(g)), flat_grads(g)


def step0_check(cfg, params, batch, env, log) -> None:
    """Step 0's loss and gradients on the card held to the port's on the
    host from the same weights and batch, in fp32 and in bf16
    (STEP0_TOL, STEP0_RATIO, STEP0_FLOOR)."""
    from repro_torch.models.transformer import on_device
    t = time.time()
    host = on_device(params, "cpu")
    with Fp32():
        c32 = loss_and_grads(params, batch, cfg, env)
        h32 = loss_and_grads(host, batch, cfg, env)
    c16 = loss_and_grads(params, batch, cfg, env)
    h16 = loss_and_grads(host, batch, cfg, env)
    del host
    e32 = leaf_rel_errs(h32[2], c32[2])
    e_card = leaf_rel_errs(h32[2], c16[2])
    e_host = leaf_rel_errs(h32[2], h16[2])
    over = {k: e_card[k] - STEP0_RATIO * e_host[k] for k in e_card}
    worst32, worst16 = max(e32, key=e32.get), max(over, key=over.get)
    log("train_step0", arch=cfg.name, loss_card_fp32=c32[0],
        loss_host_fp32=h32[0], loss_card_bf16=c16[0], loss_host_bf16=h16[0],
        grad_norm_card_fp32=c32[1], grad_norm_host_fp32=h32[1],
        grad_norm_card_bf16=c16[1], grad_norm_host_bf16=h16[1],
        fp32_worst_leaf=worst32, fp32_worst_rel_err=e32[worst32],
        bf16_worst_leaf=worst16, bf16_card_rel_err=e_card[worst16],
        bf16_host_rel_err=e_host[worst16], tol=STEP0_TOL, ratio=STEP0_RATIO,
        floor=STEP0_FLOOR, s=time.time() - t)
    check(abs(c32[0] - h32[0]) <= STEP0_TOL["loss"],
          f"train: fp32 step-0 loss card {c32[0]} vs host {h32[0]}")
    check(abs(c32[1] - h32[1]) <= STEP0_TOL["gnorm"] * h32[1],
          f"train: fp32 grad norm card {c32[1]} vs host {h32[1]}")
    check(e32[worst32] <= STEP0_TOL["leaf"], f"train: fp32 gradient "
          f"{worst32} {e32[worst32]:.2e} of its largest from the host's")
    check(abs(c16[0] - h16[0]) <= STEP0_TOL["loss_bf16"],
          f"train: bf16 step-0 loss card {c16[0]} vs host {h16[0]}")
    check(over[worst16] <= STEP0_FLOOR, f"train: bf16 gradient {worst16} "
          f"{e_card[worst16]:.3f} from the host's fp32 one, the host's bf16 "
          f"{e_host[worst16]:.3f}")


def make_loop(step, pipe, params, opt, ckpt_dir, total, ckpt_every=10**9,
              async_ckpt=True):
    """A ``TrainLoop`` of ``total`` steps that logs every step."""
    from repro_torch.train.loop import LoopConfig, TrainLoop
    return TrainLoop(LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                                ckpt_dir=ckpt_dir, log_every=1,
                                async_ckpt=async_ckpt),
                     step, pipe, params, opt)


def step_breakdown(cfg, env, ocfg, params, opt, batch) -> dict:
    """One training step in its two parts, the loss with its gradients
    (forward, recompute, backward) and the AdamW update: each part's host
    ms (ending in a sync) and, from a ``torch.profiler`` trace of it, the
    kernels it launched and their device ms (kernel rows only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import forward_loss
    from repro_torch.optim.adamw import adamw_update, value_and_grad
    out, grads = {}, None

    def grad():
        nonlocal grads
        grads = value_and_grad(lambda p: forward_loss(p, batch, cfg, env),
                               params)[1]

    def update():
        adamw_update(grads, opt, params, ocfg)

    for name, fn in (("grad", grad), ("update", update)):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.time() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[f"{name}_kernels"] = kernel_count(prof)
        out[f"{name}_device_ms"] = kernel_device_us(prof) / 1e3
    return out


def smollm_training(dev, card, log) -> None:
    """SmolLM-135M whole, as ``launch/train.py --full`` trains it:
    ``step0_check``, then TRAIN_STEPS steps of ``TrainLoop`` (loss
    descending by TRAIN_DESCENT, ms a step, tokens/s, peak memory), resume
    (RESUME_AT steps and a checkpoint, resumed to RESUME_TO, the losses
    held to the straight run's at RESUME_RTOL) and preemption (SIGUSR1
    during step PREEMPT_AT: the run ends after it with a checkpoint of
    the next step)."""
    import shutil
    import signal
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import ShardEnv, init_params
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         make_train_step)
    env, cfg = ShardEnv(None), get_config(TRAIN_ARCH)
    params = init_params(cfg, 0, dev)
    opt = init_opt_state(params)
    ocfg = AdamWConfig(peak_lr=TRAIN_LR,
                       warmup_steps=max(TRAIN_STEPS // 10, 1),
                       total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, env, ocfg)
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    step0_check(cfg, params, pipe.get_batch(0), env, log)

    root = tempfile.mkdtemp(prefix="fns_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # held before the loop starts: the parameters and AdamW state the
        # later loops start from again, which the loop's own steps replace
        # with new trees (the step is functional)
        base = torch.cuda.memory_allocated()
        loop = make_loop(step, pipe, params, opt, os.path.join(root, "a"),
                         TRAIN_STEPS)
        out = loop.run()
        losses = [m["loss"] for m in out["metrics"]]
        ms = statistics.median(loop.step_times[TRAIN_TIMED_FROM:]) * 1e3
        n_params = sum(p.numel() for p in params.parameters())
        log("train_smollm", arch=cfg.name, layers=cfg.n_layers,
            params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
            steps=TRAIN_STEPS, losses=losses, step_ms=ms,
            first_step_s=loop.step_times[0],
            tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
            max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            loop_base_gb=base / 1e9,
            start_state_gb=storage_bytes((params, opt)) / 1e9,
            descent=TRAIN_DESCENT, card=card,
            **step_breakdown(cfg, env, ocfg, loop.params, loop.opt_state,
                             pipe.get_batch(TRAIN_STEPS)))
        check(all(map(math.isfinite, losses)), "train: a non-finite loss")
        check(losses[-1] < losses[0] - TRAIN_DESCENT,
              f"train: loss {losses[0]:.3f} -> {losses[-1]:.3f} did not "
              f"descend by {TRAIN_DESCENT}")

        d = os.path.join(root, "b")
        b1 = make_loop(step, pipe, params, opt, d, RESUME_AT,
                       ckpt_every=RESUME_AT, async_ckpt=False)
        t = time.time()
        b1.run()
        save_s = time.time() - t - sum(b1.step_times)
        mb = dir_mb(d)
        b2 = make_loop(step, pipe, params, opt, d, RESUME_TO)
        t = time.time()
        start = b2.try_resume()
        resume_s = time.time() - t
        check(start == RESUME_AT, f"train: resumed at step {start}")
        out_b = b2.run(start_step=start)
        lb = {m["step"]: m["loss"] for m in out_b["metrics"]}
        check(sorted(lb) == list(range(RESUME_AT, RESUME_TO)),
              f"train: the resumed run logged steps {sorted(lb)}")
        errs = [abs(lb[s] - losses[s]) / abs(losses[s]) for s in lb]
        log("train_resume", at=RESUME_AT, to=RESUME_TO, ckpt_mb=mb,
            save_s=save_s, resume_s=resume_s, rel_errs=errs,
            rtol=RESUME_RTOL, card=card)
        check(max(errs) <= RESUME_RTOL, f"train: resumed losses "
              f"{max(errs):.2e} from the straight run's")

        d = os.path.join(root, "c")
        calls = []

        def step_and_signal(*args):
            calls.append(1)
            if len(calls) == PREEMPT_AT + 1:
                os.kill(os.getpid(), signal.SIGUSR1)
            return step(*args)

        sigs = (signal.SIGTERM, signal.SIGUSR1)
        saved = [signal.getsignal(s) for s in sigs]
        loop = make_loop(step_and_signal, pipe, params, opt, d, TRAIN_STEPS)
        loop.install_signal_handlers()
        try:
            out = loop.run()
        finally:
            for s, h in zip(sigs, saved):
                signal.signal(s, h)
        latest = ckpt.latest_step(d)
        log("train_preempt", signal_step=PREEMPT_AT,
            last_step=out["last_step"], preempted=out["preempted"],
            latest_step=latest)
        check(out["preempted"] and out["last_step"] == PREEMPT_AT + 1
              and latest == out["last_step"],
              f"train: preemption at step {PREEMPT_AT} gave {out} and a "
              f"checkpoint of step {latest}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def whisper_serving(cfg, params, env, dev, card, log) -> None:
    """whisper-small's encoder over WHISPER_FRAMES frames and its decoder:
    ``prefill`` of GEN_BATCH prompts of GEN_PROMPT tokens (timed), then
    GEN_NEW greedy ``decode_step``s (timed), the steps in WHISPER_HELD
    held to ``prefill`` over the longer sequence, in bf16 and in fp32; and
    the card's prefill of one prompt held to the host's (WHISPER_TOL)."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import (decode_step, on_device,
                                                prefill)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal(
        (GEN_BATCH, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size,
                          (GEN_BATCH, GEN_PROMPT)).astype(np.int32)

    def greedy():
        """Decode-step logits and the tokens they were fed, timed."""
        torch.cuda.synchronize()
        t = time.time()
        logits, cache = prefill(params, {"frames": frames,
                                         "tokens": prompt}, cfg, env)
        torch.cuda.synchronize()
        prefill_ms = (time.time() - t) * 1e3
        check(cache["k"].shape[2] == cfg.max_decode_len
              and cache["ck"].shape[2] == WHISPER_FRAMES,
              f"whisper: cache shapes {cache['k'].shape} {cache['ck'].shape}")
        toks, outs = [torch.from_numpy(prompt)], []
        t = time.time()
        for _ in range(GEN_NEW):
            nxt = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
            toks.append(nxt.cpu())
            logits, cache = decode_step(params, cache, {"tokens": nxt}, cfg,
                                        env)
            outs.append(logits)
        torch.cuda.synchronize()
        return outs, torch.cat(toks, dim=1).numpy(), prefill_ms, \
            (time.time() - t) * 1e3 / GEN_NEW

    def held(outs, toks):
        return [logit_rel_err(prefill(params, {
            "frames": frames, "tokens": toks[:, :GEN_PROMPT + j + 1]},
            cfg, env)[0], outs[j]) for j in WHISPER_HELD]

    greedy()   # warm-up
    outs, toks, prefill_ms, step_ms = greedy()
    check(all(bool(torch.isfinite(o[..., :cfg.vocab_size]).all())
              for o in outs), "whisper: non-finite decode logits")
    errs = held(outs, toks)
    with Fp32():
        outs32, toks32, _, _ = greedy()
        errs32 = held(outs32, toks32)
    one = {"frames": frames[:1], "tokens": prompt[:1]}
    t = time.time()
    host = on_device(params, "cpu")
    err_host = logit_rel_err(prefill(host, one, cfg, env)[0],
                             prefill(params, one, cfg, env)[0])
    with Fp32():
        err_host32 = logit_rel_err(prefill(host, one, cfg, env)[0],
                                   prefill(params, one, cfg, env)[0])
    del host
    log("whisper_serve", arch=cfg.name, frames=WHISPER_FRAMES,
        batch=GEN_BATCH, prompt=GEN_PROMPT, new=GEN_NEW,
        prefill_ms=prefill_ms, decode_step_ms=step_ms,
        tokens_per_s=GEN_BATCH / step_ms * 1e3, decode_rel_err=errs,
        decode_fp32_rel_err=errs32, host_rel_err=err_host,
        host_fp32_rel_err=err_host32, host_s=time.time() - t,
        tol=WHISPER_TOL, card=card)
    check(max(errs) <= WHISPER_TOL["decode"], f"whisper: bf16 decode vs "
          f"prefill logits {max(errs):.4f} of the max")
    check(max(errs32) <= WHISPER_TOL["fp32"], f"whisper: fp32 decode vs "
          f"prefill logits {max(errs32):.2e} of the max")
    check(err_host <= WHISPER_TOL["host"], f"whisper: bf16 card vs host "
          f"prefill logits {err_host:.4f} of the max")
    check(err_host32 <= WHISPER_TOL["fp32"], f"whisper: fp32 card vs host "
          f"prefill logits {err_host32:.2e} of the max")


def whisper_path(dev, card, log, fmesh=None, ftmesh=None) -> None:
    """whisper-small whole (``whisper_serving``; in ``fmesh``, its
    ``family_mesh`` case on the same weights; in ``ftmesh``,
    ``family_train_mesh`` on its first FTMESH_WHISPER_LAYERS), then
    WHISPER_TRAIN_STEPS
    steps of ``TrainLoop`` on ``TokenPipeline(frontend="frame")`` batches
    of TRAIN_BATCH x TRAIN_SEQ frames (ms a step, peak memory, the loss
    descending by WHISPER_DESCENT)."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import ShardEnv, init_params
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         make_train_step)
    env, cfg = ShardEnv(None), get_config(WHISPER_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev)
    whisper_serving(cfg, params, env, dev, card, log)
    if fmesh is not None:
        fmesh.run(lambda: family_mesh(cfg, params, dev, card, log))
    if ftmesh is not None:
        torch.cuda.empty_cache()
        ftmesh.run(lambda: family_train_mesh(
            *first_layers(cfg, params, FTMESH_WHISPER_LAYERS), dev, card,
            log))
    step = make_train_step(cfg, env, AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=max(WHISPER_TRAIN_STEPS // 10, 1),
        total_steps=WHISPER_TRAIN_STEPS))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                         frontend="frame", d_model=cfg.d_model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = make_loop(step, pipe, params, init_opt_state(params),
                     tempfile.gettempdir(), WHISPER_TRAIN_STEPS)
    out = loop.run()
    losses = [m["loss"] for m in out["metrics"]]
    ms = statistics.median(loop.step_times[1:]) * 1e3
    log("whisper_train", arch=cfg.name, batch=TRAIN_BATCH, frames=TRAIN_SEQ,
        dec_tokens=pipe.get_batch(0)["tokens"].shape[1], losses=losses,
        step_ms=ms, first_step_s=loop.step_times[0],
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        params=sum(p.numel() for p in params.parameters()),
        descent=WHISPER_DESCENT, card=card)
    check(all(map(math.isfinite, losses)), "whisper: a non-finite loss")
    check(losses[-1] < losses[0] - WHISPER_DESCENT,
          f"whisper: loss {losses[0]:.3f} -> {losses[-1]:.3f} did not "
          f"descend by {WHISPER_DESCENT}")


def family_step(name, dev, card, log, ftmesh=None) -> None:
    """One ``make_train_step`` of ``name`` at full width and FAMILY_LAYERS
    layers on the card, in fp32, held to the same step on the host
    (FAMILY_TOL): the loss, the grad norm and each leaf of m (the clipped
    gradient times 1 - b1); and ``adamw_update`` on the card given the
    host's gradients, each new parameter held to the host's. The
    parameters each side's own step gives are logged only: the update
    m̂ / (√v̂ + eps) is ±1 for large gradients but steep where a gradient
    times the clip scale is near eps, so a rounding-sized gradient
    difference there moves a parameter by up to 2 lr. The card's bf16
    step is logged beside."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import (ShardEnv, forward_loss,
                                                init_params, on_device)
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_opt_state, make_train_step,
                                         tree_map, value_and_grad)
    env = ShardEnv(None)
    cfg = dataclasses.replace(get_config(name), n_layers=FAMILY_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev)
    ocfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, env, ocfg)
    batch = TokenPipeline(cfg.vocab_size, FAMILY_BATCH, FAMILY_SEQ,
                          seed=0).get_batch(0)

    def timed(p):
        torch.cuda.synchronize()
        t = time.time()
        out = step(p, init_opt_state(p), batch)
        float(out[2]["loss"])
        return out, (time.time() - t) * 1e3

    timed(params)   # warm-up
    (_, _, m16), ms16 = timed(params)
    with Fp32():
        timed(params)
        (pc, oc, mc), ms = timed(params)
        t = time.time()
        host = on_device(params, "cpu")
        loss_h, gh = value_and_grad(
            lambda p: forward_loss(p, batch, cfg, env), host)
        ph, oh, mh = adamw_update(gh, init_opt_state(host), host, ocfg)
        host_s = time.time() - t
        pu = adamw_update(tree_map(lambda g: g.to(dev), gh),
                          init_opt_state(params), params, ocfg)[0]
    lr = float(mh["lr"])

    def lr_errs(got):
        want, got = flat_grads(ph), flat_grads(got)
        return {k: float((got[k].detach().cpu() - want[k].detach())
                         .abs().max()) / lr for k in want}

    e_m = leaf_rel_errs(flat_grads(oh["m"]), flat_grads(oc["m"]))
    e_own, e_upd = lr_errs(pc), lr_errs(pu)
    worst_m, worst_own = max(e_m, key=e_m.get), max(e_own, key=e_own.get)
    worst_upd = max(e_upd, key=e_upd.get)
    loss_c, loss_h = float(mc["loss"]), float(loss_h)
    gn_c, gn_h = float(mc["grad_norm"]), float(mh["grad_norm"])
    log("train_family_step", arch=name, layers=FAMILY_LAYERS,
        params=sum(p.numel() for p in params.parameters()),
        batch=FAMILY_BATCH, seq=FAMILY_SEQ, loss_card_fp32=loss_c,
        loss_host_fp32=loss_h, loss_card_bf16=float(m16["loss"]),
        grad_norm_card=gn_c, grad_norm_host=gn_h, m_worst_leaf=worst_m,
        m_rel_err=e_m[worst_m], own_step_worst_leaf=worst_own,
        own_step_param_err_lr=e_own[worst_own], update_worst_leaf=worst_upd,
        update_param_err_lr=e_upd[worst_upd], step_ms_fp32=ms,
        step_ms_bf16=ms16, host_s=host_s,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        tol=FAMILY_TOL, card=card)
    check(math.isfinite(float(m16["loss"])), f"{name}: bf16 step loss")
    check(abs(loss_c - loss_h) <= FAMILY_TOL["loss"],
          f"{name}: fp32 step loss card {loss_c} vs host {loss_h}")
    check(abs(gn_c - gn_h) <= FAMILY_TOL["leaf"] * gn_h,
          f"{name}: grad norm card {gn_c} vs host {gn_h}")
    check(e_m[worst_m] <= FAMILY_TOL["leaf"],
          f"{name}: m leaf {worst_m} {e_m[worst_m]:.2e} from the host's")
    check(e_upd[worst_upd] <= FAMILY_TOL["update_lr"],
          f"{name}: the update of the host's gradients moved {worst_upd} "
          f"{e_upd[worst_upd]:.2e} lr from the host's")
    del pc, oc, mc, ph, oh, mh, gh, host, pu
    if ftmesh is not None:
        torch.cuda.empty_cache()
        ftmesh.run(lambda: family_train_mesh(cfg, params, dev, card, log))


def token_losses(params, batch, cfg):
    """Each token's loss term of ``forward_loss`` (B, S): the
    cross-entropy plus the z-loss, from the same layers and head."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models.common import rms_norm, unembed_logits
    with torch.no_grad():
        h = tf._stack_forward(params, cfg, tf._embed(params, batch), "train")
        logits = unembed_logits(rms_norm(h, params.final_norm, cfg.norm_eps),
                                params.unembed, cfg.vocab_size)
        lse = torch.logsumexp(logits, dim=-1)
        labels = tf._ids(params, batch["labels"])
        gold = logits.gather(-1, labels[..., None])[..., 0]
        return lse - gold + 1e-4 * lse.square()


def dbrx_step(dev, card, log) -> None:
    """dbrx-132b at full width and DBRX_LAYERS layer: the loss and its
    gradients in bf16 through the capacity path (no AdamW state: its
    4.49 B fp32 masters and their gradients take ~36 GB), all finite;
    then, at a dropless capacity factor (E / k), each token's loss in
    bf16 held to fp32 on the tokens whose experts agree (DBRX_TOL), the
    per-token losses' mean checked against ``forward_loss``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import (ShardEnv, forward_loss,
                                                init_params)
    from repro_torch.optim.adamw import global_norm, value_and_grad
    env = ShardEnv(None)
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=DBRX_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, dev)
    batch = TokenPipeline(cfg.vocab_size, DBRX_BATCH, DBRX_SEQ,
                          seed=0).get_batch(0)
    torch.cuda.synchronize()
    t = time.time()
    loss, grads = value_and_grad(
        lambda p: forward_loss(p, batch, cfg, env), params)
    gn = float(global_norm(grads))
    grad_ms = (time.time() - t) * 1e3
    finite = all(bool(torch.isfinite(g).all()) for g in flat_grads(grads)
                 .values())
    zero = [k for k, g in flat_grads(grads).items() if not g.any()]
    del grads
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(float(loss)) and math.isfinite(gn) and finite,
          "dbrx: non-finite loss or gradient")
    check(not zero, f"dbrx: zero gradients {zero}")
    dcfg = dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.moe_top_k)
    with Routes() as r16:
        l16 = token_losses(params, batch, dcfg)
    with Fp32(), Routes() as r32:
        l32 = token_losses(params, batch, dcfg)
        mean32 = float(forward_loss(params, batch, dcfg, env).detach())
    same = (r16[0].sort(-1).values == r32[0].sort(-1).values).all(-1)
    same = same.reshape(l16.shape)
    diff = (l16 - l32).abs()[same]
    log("train_dbrx_step", arch=cfg.name, layers=DBRX_LAYERS,
        params=sum(p.numel() for p in params.parameters()),
        batch=DBRX_BATCH, seq=DBRX_SEQ, loss_bf16=float(loss), grad_norm=gn,
        grad_ms=grad_ms, max_memory_gb=peak,
        tokens_same_experts=float(same.float().mean()),
        token_loss_max_diff=float(diff.max()),
        mean_loss_bf16=float(l16[same].mean()),
        mean_loss_fp32=float(l32[same].mean()),
        fp32_forward_loss=mean32, tol=DBRX_TOL, card=card)
    check(abs(float(l32.mean()) - mean32) <= 1e-5 * abs(mean32),
          "dbrx: per-token losses do not average to forward_loss")
    check(bool(same.any()), "dbrx: no token's experts agree bf16 vs fp32")
    check(float(diff.max()) <= DBRX_TOL["token"],
          f"dbrx: bf16 vs fp32 token loss {float(diff.max()):.4f}")
    check(abs(float(l16[same].mean() - l32[same].mean()))
          <= DBRX_TOL["mean"], "dbrx: bf16 vs fp32 mean token loss")


def train_path(dev, card, log, fmesh=None, ftmesh=None) -> dict:
    """Training on the card (random weights from ``init_params`` seed 0,
    one model at a time, each freed before the next):
    ``smollm_training``, ``whisper_path`` (with whisper's ``family_mesh``
    case in ``fmesh``), ``family_step`` of hymba and rwkv6,
    ``dbrx_step``; the three families' ``family_train_mesh`` in
    ``ftmesh``. It launches none of K1-K5. Returns the path's launch
    counts."""
    import torch

    from repro_torch.kernels import build
    t_path = time.time()
    build.LAUNCHES.clear()
    parts = [("smollm", lambda: smollm_training(dev, card, log)),
             ("whisper", lambda: whisper_path(dev, card, log, fmesh,
                                              ftmesh))]
    parts += [(n, lambda n=n: family_step(n, dev, card, log, ftmesh))
              for n in FAMILY_STEPS]
    parts.append(("dbrx", lambda: dbrx_step(dev, card, log)))
    for name, part in parts:
        t = time.time()
        torch.cuda.empty_cache()
        part()
        log("train_part", part=name, s=time.time() - t)
    torch.cuda.empty_cache()
    launches = path_launches("train", (), log)
    log("train_path", s=time.time() - t_path)
    return launches


# -- training over a mesh -------------------------------------------------------

TMESH_ARCH = "llama3.2-1b"
TMESH_SHAPE = (2, 4)      # data x model cells, every one on the card, tp
TMESH_BATCH, TMESH_SEQ, TMESH_STEPS = 8, 128, 3
# the mesh's fp32 step held to the meshless one on the same weights and
# batches (FAMILY_TOL's bounds: the step-1 loss, each step-1 gradient
# leaf of its largest magnitude, the update of the same gradients in lr)
TMESH_TOL = dict(loss=2e-5, leaf=1e-4, update_lr=1e-3)
# ZeRO-1 off and on (tests/test_zero1.py's setting: 4 x 2 "dp", bf16
# compute, lr 1e-2, one batch three times) and its bounds; the losses
# also held to the meshless run's
ZERO1_SHAPE, ZERO1_LR = (4, 2), 1e-2
ZERO1_LAYERS = 8          # of llama's 16: every cell's partial gradient of
# the replicated model lives on the one card (8 x its fp32 bytes; 16
# layers would not fit). At 4, lr 1e-2 drove the loss 11.8 -> 23.0 in
# three steps and the runs 2.3% apart (PERF.md section 4)
ZERO1_TOL = dict(step1=1e-5, rtol=2e-3, meshless=1e-2)
# TrainLoop on SmolLM-135M (launch/train.py --full's model) in fp32: 6
# steps on 1 x 3 "tp" straight (a checkpoint after 3), and an elastic
# resume of that checkpoint onto 3 x 1 "dp" with ZeRO-1 for 3 more (the
# batch divides 3)
ELASTIC_FROM, ELASTIC_TO = ((1, 3), "tp", False), ((3, 1), "dp", True)
ELASTIC_BATCH, ELASTIC_AT, ELASTIC_STEPS = 6, 3, 6


def device_kernels(fn) -> int:
    """Kernels (and copies) one call of ``fn`` ran on the card, counted
    from the raw events of a trace of the card's activity alone:
    ``step_kernels``'s ``key_averages`` over host and device events costs
    tens of seconds for a mesh step's ~40 k kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def placed_bytes(tree) -> int:
    """Bytes of the distinct storages a placed tree's blocks hold (one
    copy a device, not one a cell)."""
    from repro_torch.optim.adamw import leaves
    seen = {}
    for leaf in leaves(tree):
        for x in leaf.shards.flat:
            if x is not None:
                st = x.untyped_storage()
                seen[(x.device, st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def mesh_env(shape, policy, dev):
    import numpy as np

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import ShardEnv
    return ShardEnv(make_local_mesh(*shape, devices=[dev] * int(
        np.prod(shape))), policy=policy)


def mesh_opt(cfg, env, params, zero1: bool):
    """``init_opt_state`` of placed parameters by ``opt_shardings``."""
    import torch

    from repro_torch.launch.shardings import opt_shardings
    from repro_torch.optim.adamw import init_opt_state
    return init_opt_state(params, opt_shardings(
        cfg, env.mesh, {"m": params, "v": params, "step": torch.zeros(())},
        env.policy, zero1))


def mesh_vs_meshless(dev, card, log) -> None:
    """llama3.2-1b at its published widths (random weights, seed 0) on a
    2 x 4 mesh of cells on the card, tp, ZeRO-1, in fp32: the step-1
    loss and every gradient leaf over the mesh held to the meshless ones
    (TMESH_TOL), ``adamw_update`` of the meshless gradients placed on the
    mesh held to the meshless update, then TMESH_STEPS ``make_train_step``
    steps each way on ``TokenPipeline`` batches (ms a step, kernels a
    step from ``device_kernels``, peak memory, the placed m/v's bytes:
    one copy on the card)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.placement import gather, place_tree
    from repro_torch.launch.shardings import param_shardings
    from repro_torch.models.transformer import (ShardEnv, forward_loss,
                                                init_params, place_params)
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         init_opt_state, leaves,
                                         leaves_with_path, make_train_step,
                                         value_and_grad)
    t0 = time.time()
    cfg = get_config(TMESH_ARCH)
    one = ShardEnv(None)
    env = mesh_env(TMESH_SHAPE, "tp", dev)
    pipe = TokenPipeline(cfg.vocab_size, TMESH_BATCH, TMESH_SEQ, seed=0)
    ocfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                       total_steps=TMESH_STEPS)
    secs: dict = {}   # seconds of each part, ending in a sync
    with Fp32():
        params = init_params(cfg, 0, dev)
        p_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        placed = place_params(params, env)
        batch = pipe.get_batch(0)
        t = time.time()
        loss1, g1 = value_and_grad(
            lambda p: forward_loss(p, batch, cfg, one), params)
        loss1 = float(loss1)
        secs["meshless_grads"] = time.time() - t
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        t = time.time()
        loss_m, gm = value_and_grad(
            lambda p: forward_loss(p, batch, cfg, env), placed)
        loss_m = float(loss_m)
        secs["mesh_grads"] = time.time() - t
        grad_peak = torch.cuda.max_memory_allocated() - m0
        t = time.time()
        worst, err = None, 0.0
        for (path, a), b in zip(leaves_with_path(g1), leaves(gm)):
            e = float((gather(b) - a).abs().max() / a.abs().max().clamp(
                min=1e-30))
            if e >= err:
                worst, err = "/".join(path), e
        del gm
        opt = mesh_opt(cfg, env, placed, True)
        mv_bytes = placed_bytes({"m": opt["m"], "v": opt["v"]})
        want = adamw_update(g1, init_opt_state(params), params, ocfg)[0]
        got = adamw_update(place_tree(g1, param_shardings(
            cfg, env.mesh, params, "tp")), opt, placed, ocfg)[0]
        upd = max(float((gather(b) - a.detach()).abs().max())
                  for a, b in zip(leaves(want), leaves(got)))
        upd /= TRAIN_LR
        del g1, want, got, opt
        secs["checks"] = time.time() - t
        torch.cuda.empty_cache()
        runs = {}
        for name in ("meshless", "mesh"):
            e, p = (one, params) if name == "meshless" else (env, placed)
            o = (init_opt_state(p) if name == "meshless"
                 else mesh_opt(cfg, env, p, True))
            step = make_train_step(cfg, e, ocfg)
            losses, times = [], []
            for i in range(TMESH_STEPS):
                torch.cuda.synchronize()
                t = time.time()
                p, o, m = step(p, o, pipe.get_batch(i))
                losses.append(float(m["loss"]))
                times.append((time.time() - t) * 1e3)
            t = time.time()
            kernels = device_kernels(lambda: step(p, o, pipe.get_batch(0)))
            secs[name + "_profiled_step"] = time.time() - t
            runs[name] = dict(losses=losses, step_ms=times,
                              step_kernels=kernels)
            del p, o, step
            torch.cuda.empty_cache()
    rel = abs(loss_m - loss1) / abs(loss1)
    log("train_mesh_llama", arch=cfg.name, mesh=list(TMESH_SHAPE),
        policy="tp", zero1=True, layers=cfg.n_layers, d=cfg.d_model,
        batch=TMESH_BATCH, seq=TMESH_SEQ, params_gb=p_bytes / 1e9,
        mv_gb=mv_bytes / 1e9, mv_over_params=mv_bytes / p_bytes,
        grad_peak_gb=grad_peak / 1e9, loss_mesh=loss_m,
        loss_meshless=loss1, loss_rel_err=rel, grad_worst_leaf=worst,
        grad_rel_err=err, update_err_lr=upd, tol=TMESH_TOL,
        mesh_steps=runs["mesh"], meshless_steps=runs["meshless"],
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, secs=secs,
        s=time.time() - t0, card=card)
    check(rel <= TMESH_TOL["loss"], f"train_mesh: step-1 loss mesh "
          f"{loss_m} vs meshless {loss1}")
    check(err <= TMESH_TOL["leaf"], f"train_mesh: gradient {worst} "
          f"{err:.2e} of its largest from the meshless one")
    check(upd <= TMESH_TOL["update_lr"], f"train_mesh: the update of the "
          f"same gradients moved a parameter {upd:.2e} lr from meshless")
    check(mv_bytes <= 2 * p_bytes * 1.01, f"train_mesh: placed m and v "
          f"take {mv_bytes} bytes for {p_bytes} bytes of parameters")
    check(all(map(math.isfinite, runs["mesh"]["losses"])),
          "train_mesh: a non-finite loss")


def zero1_on_off(dev, card, log) -> None:
    """``tests/test_zero1.py``'s check at llama3.2-1b's widths
    (ZERO1_LAYERS of its layers) on a 4 x 2 "dp" mesh of cells on the
    card in bf16: three steps of one batch with ZeRO-1 off and on, the
    step-1 losses within ZERO1_TOL["step1"] and all within its rtol
    (whether they are equal is logged), and both held to the meshless
    run's within ZERO1_TOL["meshless"]."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import (ShardEnv, init_params,
                                                place_params)
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         make_train_step)
    t0 = time.time()
    cfg = dataclasses.replace(get_config(TMESH_ARCH), n_layers=ZERO1_LAYERS)
    ocfg = AdamWConfig(peak_lr=ZERO1_LR, warmup_steps=1)
    batch = TokenPipeline(cfg.vocab_size, TMESH_BATCH, TMESH_SEQ,
                          seed=0).get_batch(0)
    params = init_params(cfg, 0, dev)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = {}, {}
    for name in ("meshless", "zero1_off", "zero1_on"):
        if name == "meshless":
            env = ShardEnv(None)
            p, o = params, init_opt_state(params)
        else:
            env = mesh_env(ZERO1_SHAPE, "dp", dev)
            p = place_params(params, env)
            o = mesh_opt(cfg, env, p, name == "zero1_on")
        step = make_train_step(cfg, env, ocfg)
        ls = []
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(3):
            p, o, m = step(p, o, batch)
            ls.append(float(m["loss"]))
        ms[name] = (time.time() - t) * 1e3 / 3
        losses[name] = ls
        del p, o, step
        torch.cuda.empty_cache()
    a, b, c = losses["zero1_off"], losses["zero1_on"], losses["meshless"]
    vs = max(abs(x - y) / abs(y) for run in (a, b) for x, y in zip(run, c))
    log("train_mesh_zero1", arch=cfg.name, layers=cfg.n_layers,
        mesh=list(ZERO1_SHAPE), policy="dp", lr=ZERO1_LR, losses=losses,
        equal=a == b, vs_meshless_rel=vs, step_ms=ms, tol=ZERO1_TOL,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        s=time.time() - t0, card=card)
    check(abs(a[0] - b[0]) < ZERO1_TOL["step1"]
          and np.allclose(a, b, rtol=ZERO1_TOL["rtol"]),
          f"train_mesh: ZeRO-1 off {a} vs on {b}")
    check(vs <= ZERO1_TOL["meshless"], f"train_mesh: mesh losses {a} {b} "
          f"vs meshless {c}")


def elastic_resume(dev, card, log) -> None:
    """``TrainLoop`` on SmolLM-135M in fp32 over a 1 x 3 "tp" mesh:
    ELASTIC_STEPS steps straight through (ELASTIC_AT with a checkpoint,
    then the rest on the same state); a loop on 3 x 1 "dp" with ZeRO-1
    (each layer's m/v on the data block of its layer: 30 layers over 3)
    resumes the checkpoint by ``try_resume(shardings)`` and runs the
    rest: its losses within RESUME_RTOL of the straight run's."""
    import shutil
    import tempfile

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.shardings import opt_shardings, param_shardings
    from repro_torch.models.transformer import init_params, place_params
    from repro_torch.optim.adamw import AdamWConfig, make_train_step
    t0 = time.time()
    cfg = get_config(TRAIN_ARCH)
    pipe = TokenPipeline(cfg.vocab_size, ELASTIC_BATCH, TRAIN_SEQ, seed=0)
    ocfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1,
                       total_steps=ELASTIC_STEPS)
    root = tempfile.mkdtemp(prefix="fns_train_mesh_")
    try:
        with Fp32():
            params = init_params(cfg, 0, dev)
            loops = {}
            for name, (shape, pol, z) in (("from", ELASTIC_FROM),
                                          ("to", ELASTIC_TO)):
                env = mesh_env(shape, pol, dev)
                p = place_params(params, env)
                loops[name] = (env, p, mesh_opt(cfg, env, p, z),
                               make_train_step(cfg, env, ocfg))
            # straight through: ELASTIC_AT steps with a checkpoint, then
            # the rest on the same state in memory
            env, p, o, step = loops["from"]
            d = os.path.join(root, "b")
            first = make_loop(step, pipe, p, o, d, ELASTIC_AT,
                              ckpt_every=ELASTIC_AT, async_ckpt=False)
            want = [m["loss"] for m in first.run()["metrics"]]
            save_s = time.time() - t0
            rest = make_loop(step, pipe, first.params, first.opt_state,
                             os.path.join(root, "a"), ELASTIC_STEPS)
            want += [m["loss"] for m in rest.run(
                start_step=ELASTIC_AT)["metrics"]]
            tp_ms = statistics.median(first.step_times
                                      + rest.step_times) * 1e3
            save_s -= sum(first.step_times)
            del first, rest, loops["from"]
            env, p, o, step = loops["to"]
            (shape, pol, z) = ELASTIC_TO
            stacked = interop.reference_shapes(p)
            where = {"params": param_shardings(cfg, env.mesh, stacked, pol),
                     "opt": opt_shardings(cfg, env.mesh, {
                         "m": stacked, "v": stacked,
                         "step": torch.zeros(())}, pol, z)}
            loop = make_loop(step, pipe, p, o, d, ELASTIC_STEPS)
            t = time.time()
            start = loop.try_resume(where)
            resume_s = time.time() - t
            check(start == ELASTIC_AT, f"train_mesh: resumed at {start}")
            out = loop.run(start_step=start)
            got = {m["step"]: m["loss"] for m in out["metrics"]}
            ms = statistics.median(loop.step_times) * 1e3
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(sorted(got) == list(range(ELASTIC_AT, ELASTIC_STEPS)),
          f"train_mesh: the resumed run logged steps {sorted(got)}")
    errs = [abs(got[s] - want[s]) / abs(want[s]) for s in got]
    log("train_mesh_elastic", arch=cfg.name, batch=ELASTIC_BATCH,
        seq=TRAIN_SEQ, straight=want, resumed=got, rel_errs=errs,
        rtol=RESUME_RTOL, resume_s=resume_s, tp_step_ms=tp_ms,
        dp_step_ms=ms, save_s=save_s,
        s=time.time() - t0, card=card)
    check(max(errs) <= RESUME_RTOL, f"train_mesh: losses after the elastic "
          f"resume {max(errs):.2e} from the straight run's")


def train_mesh_path(dev, card, log) -> None:
    """Training over a mesh, every cell on the card (``devices=[cuda:0] *
    n``), launching none of K1-K5: ``mesh_vs_meshless``,
    ``zero1_on_off`` and ``elastic_resume``, each freed before the
    next."""
    import torch
    t = time.time()
    for part in (mesh_vs_meshless, zero1_on_off, elastic_resume):
        torch.cuda.empty_cache()
        part(dev, card, log)
    torch.cuda.empty_cache()
    log("train_mesh_models", s=time.time() - t)


# -- the hybrid, ssm and audio families trained over a mesh ---------------------

FTMESH_SHAPE = (2, 4)     # data x model cells, every one on the card, tp
FTMESH_BATCH, FTMESH_SEQ = 8, 64
FTMESH_FRAMES = 256       # whisper's encoder frames a sequence
FTMESH_WHISPER_LAYERS = 4   # of 12 + 12; hymba and rwkv6 at FAMILY_LAYERS
# rwkv6's per-head group norm (``models.rwkv6.GN_EPS``, 6.4e-4) divides
# heads whose output varies next to nothing (the first positions of a
# random-weight sequence), so any change in the order of its fp32 sums
# moves every gradient leaf by 1-5e-4 of its largest: the meshless halves
# of one batch against the whole, the card against the host, each mesh
# shape alike (H100 80GB HBM3 at 700 W, at most 4.6e-4; PERF.md section
# 6). Its leaves are held to FTMESH_RWKV_LEAF, a fixed bound above those
# readings, and, with the group norm's eps at FTMESH_GN_EPS (the heads
# then well conditioned), to TMESH_TOL as the other families' are.
FTMESH_RWKV_LEAF = 1e-3
FTMESH_GN_EPS = 1.0


def _ftmesh_grads(cfg, params, placed, batch, env) -> dict:
    """The loss and gradients of ``batch`` meshless and over ``env``'s
    mesh (fp32): both losses, each leaf's largest difference relative to
    the meshless leaf's largest, and the memory the mesh's gradients took
    beyond what was allocated before them."""
    import torch

    from repro_torch.launch.placement import gather
    from repro_torch.models.transformer import ShardEnv, forward_loss
    from repro_torch.optim.adamw import (leaves, leaves_with_path,
                                         value_and_grad)
    one = ShardEnv(None)
    loss1, g1 = value_and_grad(lambda p: forward_loss(p, batch, cfg, one),
                               params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    loss_m, gm = value_and_grad(lambda p: forward_loss(p, batch, cfg, env),
                                placed)
    peak = torch.cuda.max_memory_allocated() - m0
    errs = {"/".join(path): float((gather(b) - a).abs().max()
                                  / a.abs().max().clamp(min=1e-30))
            for (path, a), b in zip(leaves_with_path(g1), leaves(gm))}
    del g1, gm
    torch.cuda.empty_cache()
    return dict(loss=float(loss1), loss_mesh=float(loss_m), errs=errs,
                peak=peak)


def family_train_mesh(cfg, params, dev, card, log) -> None:
    """``cfg``'s model on the card (``params``, fp32 masters) trained on
    an FTMESH_SHAPE mesh of cells on the card, tp, in fp32, on one
    numpy-seeded batch of FTMESH_BATCH x FTMESH_SEQ tokens (whisper: and
    FTMESH_FRAMES frames): the step-1 loss over the mesh held to the
    meshless one (TMESH_TOL) and every gradient leaf within
    TMESH_TOL["leaf"] (rwkv6: FTMESH_RWKV_LEAF, and TMESH_TOL["leaf"]
    with its group norm's eps at FTMESH_GN_EPS); then one
    ``make_train_step`` each way, the mesh's with ZeRO-1 (ms a step, and
    kernels a step from ``device_kernels``), and the memory the mesh's
    gradients took beyond what was allocated before them."""
    import numpy as np
    import torch

    from repro_torch.models import rwkv6
    from repro_torch.models.transformer import ShardEnv, place_params
    from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                         make_train_step)
    t0 = time.time()
    one = ShardEnv(None)
    env = mesh_env(FTMESH_SHAPE, "tp", dev)
    rng = np.random.default_rng(0)
    shape = (FTMESH_BATCH, FTMESH_SEQ)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab_size, shape).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (FTMESH_BATCH, FTMESH_FRAMES, cfg.d_model)).astype(np.float32)
    ocfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    ssm = cfg.family == "ssm"
    with Fp32():
        placed = place_params(params, env)
        got = _ftmesh_grads(cfg, params, placed, batch, env)
        conditioned = None
        if ssm:
            saved, rwkv6.GN_EPS = rwkv6.GN_EPS, FTMESH_GN_EPS
            try:
                conditioned = _ftmesh_grads(cfg, params, placed, batch, env)
            finally:
                rwkv6.GN_EPS = saved
        runs = {}
        for name in ("meshless", "mesh"):
            e, p = (one, params) if name == "meshless" else (env, placed)
            o = (init_opt_state(p) if name == "meshless"
                 else mesh_opt(cfg, env, p, True))
            step = make_train_step(cfg, e, ocfg)
            torch.cuda.synchronize()
            t = time.time()
            _, _, m = step(p, o, batch)
            loss = float(m["loss"])
            ms = (time.time() - t) * 1e3
            kernels = device_kernels(lambda: step(p, o, batch))
            runs[name] = dict(loss=loss, step_ms=ms, step_kernels=kernels)
            del o, step, m
            torch.cuda.empty_cache()

    def worst(g):
        key = max(g["errs"], key=g["errs"].get)
        return key, g["errs"][key], (abs(g["loss_mesh"] - g["loss"])
                                     / abs(g["loss"]))
    leaf_tol = FTMESH_RWKV_LEAF if ssm else TMESH_TOL["leaf"]
    key, err, rel = worst(got)
    extra = {}
    if conditioned is not None:
        ckey, cerr, crel = worst(conditioned)
        extra = dict(gn_eps=FTMESH_GN_EPS, conditioned_worst_leaf=ckey,
                     conditioned_rel_err=cerr, conditioned_loss_rel_err=crel)
    layers = [cfg.n_layers] + ([cfg.n_enc_layers] if cfg.n_enc_layers
                               else [])
    log("family_train_mesh", arch=cfg.name, mesh=list(FTMESH_SHAPE),
        policy="tp", zero1_step=True, layers=layers, d=cfg.d_model,
        batch=FTMESH_BATCH, seq=FTMESH_SEQ,
        frames=FTMESH_FRAMES if cfg.family == "audio" else None,
        loss_mesh=got["loss_mesh"], loss_meshless=got["loss"],
        loss_rel_err=rel, grad_worst_leaf=key, grad_rel_err=err,
        leaf_tol=leaf_tol, tol=TMESH_TOL, **extra,
        grad_peak_gb=got["peak"] / 1e9, mesh_step=runs["mesh"],
        meshless_step=runs["meshless"],
        kernels_over_meshless=runs["mesh"]["step_kernels"]
        / max(runs["meshless"]["step_kernels"], 1),
        s=time.time() - t0, card=card)
    check(rel <= TMESH_TOL["loss"], f"family_train_mesh {cfg.name}: step-1 "
          f"loss mesh {got['loss_mesh']} vs meshless {got['loss']}")
    check(err <= leaf_tol, f"family_train_mesh {cfg.name}: gradient leaf "
          f"{key} {err:.2e} of its largest from the meshless one (bound "
          f"{leaf_tol:.0e})")
    if conditioned is not None:
        check(crel <= TMESH_TOL["loss"] and cerr <= TMESH_TOL["leaf"],
              f"family_train_mesh {cfg.name} (group norm eps "
              f"{FTMESH_GN_EPS}): loss {crel:.2e}, gradient leaf {ckey} "
              f"{cerr:.2e} from the meshless ones")
    check(all(math.isfinite(r["loss"]) for r in runs.values()),
          f"family_train_mesh {cfg.name}: a non-finite step loss")
    check(abs(runs["mesh"]["loss"] - got["loss"])
          <= TMESH_TOL["loss"] * abs(got["loss"]),
          f"family_train_mesh {cfg.name}: the ZeRO-1 step's loss "
          f"{runs['mesh']['loss']} vs meshless {got['loss']}")


# -- the cost model (launch/{dryrun,accounting,roofline}.py) and the hier atlas

COST_ARCH = "smollm-135m"
# dry-run cells, each through the CLI in its own process, all at once:
# (arch, shape, accounting pass, --mesh: single = one card, both = a chip
# of 16 x 16 and of 2 x 16 x 16). A mesh row traces one cell of it, as
# long as a one-card row; SmolLM's prefill_32k on the meshes is an
# accounting pass (two depths, 8 s): its full traces (~190 s a mesh)
# beside the corpus build slowed the build by 29 s (PERF.md section 6)
DRY_CELLS = (("smollm-135m", "decode_32k", False, "single"),
             ("smollm-135m", "train_4k", False, "single"),
             ("smollm-135m", "prefill_32k", False, "single"),
             ("llama3.2-1b", "decode_32k", False, "single"),
             ("hymba-1.5b", "prefill_32k", True, "single"),
             ("smollm-135m", "decode_32k", False, "both"),
             ("smollm-135m", "train_4k", False, "both"),
             ("smollm-135m", "prefill_32k", True, "both"),
             ("hymba-1.5b", "prefill_32k", True, "both"))
DRY_TIMEOUT_S = 400  # a 32k prefill traces ~1.7 M ops: about 130 s
# the real steps held to their meta traces: (kind, sequence, batch); the
# prefill at 512 tokens, where the default attention chunks and the
# accounting mode's coincide, so bytes extrapolate exactly too
COST_STEPS = (("train", 128, 8), ("prefill", 512, 8), ("decode", 1024, 8))
COST_TIMED = 7       # timed runs of each step (median), after 2 warm-ups
PEAK_RTOL = 0.15     # predicted peak vs max_memory_allocated
EXTRAP_RTOL = 1e-9   # two-depth extrapolation vs the full-depth trace
HIER_Q = "conj_q64"  # the batch the flat and the hierarchical atlas run
HIER_RECALL_GAP = 0.08


class DryRuns:
    """The dry-run CLI (``python -m repro_torch.launch.dryrun``) on each
    of DRY_CELLS, one process a cell, all started together at the lowest
    priority in a scratch directory that holds their ``results/``; each
    traces on ``meta`` on the host and reads the card's name and memory
    itself. ``drive_paths`` starts them beside the corpus build (set-up,
    no path's metric) and ``join``s them before the first timed phase, so
    no path runs beside them; ``close`` kills any still running and
    removes the directory."""

    def __init__(self):
        import tempfile
        self.t0 = time.time()
        self.dir = tempfile.mkdtemp(prefix="fns_dryrun_")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        self.procs = []
        for arch, shape, acct, mesh in DRY_CELLS:
            cmd = ["nice", "-n", "19", sys.executable, "-m",
                   "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh] + (["--accounting"] if acct
                                             else [])
            self.procs.append(subprocess.Popen(
                cmd, cwd=self.dir, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

    def join(self, log) -> list:
        """Each cell's record once its process has ended; a process that
        failed, or outran DRY_TIMEOUT_S from the start, fails the
        smoke."""
        t = time.time()
        out = []
        for (arch, shape, acct, mesh), proc in zip(DRY_CELLS, self.procs):
            left = DRY_TIMEOUT_S - (time.time() - self.t0)
            try:
                tail, _ = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"dryrun {arch} {shape} {mesh}: still "
                                   f"running after {DRY_TIMEOUT_S} s") \
                    from None
            log("dryrun_process", arch=arch, shape=shape, accounting=acct,
                mesh=mesh, rc=proc.returncode, ended_s=time.time() - self.t0,
                tail=tail[-2000:])
            check(proc.returncode == 0,
                  f"dryrun {arch} {shape} {mesh}: exit {proc.returncode}")
            for tag in (("pod", "multi") if mesh == "both" else (mesh,)):
                path = os.path.join(self.dir, "results", "torch",
                                    "accounting" if acct else "dryrun",
                                    f"{arch}__{shape}__{tag}.json")
                with open(path) as f:
                    out.append(dict(arch=arch, shape=shape, accounting=acct,
                                    mesh=tag, record=json.load(f)))
        log("dryrun_join", waited_s=time.time() - t,
            since_start_s=time.time() - self.t0)
        return out

    def close(self):
        import shutil
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dry_records(runs, chip, card, log) -> None:
    """The dry-run cells' records (``DryRuns.join``): FLOPs, bytes, peak,
    ``fits`` and the dominant term, on the constants the card's name
    selects."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.dryrun import MESHES
    for run in runs:
        rec = run["record"]
        mesh, chips = MESHES[run["mesh"]][:2]
        what = f"dry-run {run['arch']} {run['shape']} {mesh}"
        if run["accounting"]:
            t = rf.roofline_terms(rec["flops"], rec["bytes"],
                                  rec["wire_bytes"], chip,
                                  rec.get("network_bytes", 0.0))
            vals = dict(flops=rec["flops"], bytes=rec["bytes"],
                        wire_bytes=rec["wire_bytes"],
                        wire_by_kind=rec["coll_by_kind"], l1=rec["l1"],
                        l2=rec["l2"], accounting_s=rec["accounting_s"],
                        dominant=t.dominant, bound_s=t.bound_time_s)
            mf = rf.model_flops(get_config(run["arch"]), SHAPES[run["shape"]])
            check(rec.get("mesh", "1xH100") == mesh, f"{what}: mesh")
        else:
            check(rec["chip"] == chip.name and rec["mesh"] == mesh
                  and rec["chips"] == chips,
                  f"{what}: chip {rec['chip']} mesh {rec['mesh']}")
            m, r = rec["memory"], rec["roofline"]
            c = rec["collectives"]
            vals = dict(flops=rec["flops_per_chip"],
                        bytes=rec["bytes_per_chip"],
                        kernel_ops=rec["kernel_ops"],
                        argument_bytes=m["argument_bytes"],
                        peak_bytes=m["peak_bytes"], fits=m["fits"],
                        capacity_bytes=m["capacity_bytes"],
                        wire_bytes=c["wire_bytes"], wire_by_kind=c["by_kind"],
                        coll_counts=c["counts"],
                        priced_by=c.get("priced_by", {}),
                        dominant=r["dominant"], compute_s=r["compute_s"],
                        memory_s=r["memory_s"],
                        collective_s=r["collective_s"],
                        useful_flops_ratio=r["useful_flops_ratio"],
                        cells_traced=len(rec.get("cells_traced", [[]])),
                        trace_s=rec["lower_s"])
            check(m["fits"] == (m["peak_bytes"] <= m["capacity_bytes"]),
                  "fits disagrees with the peak")
            check(r["useful_flops_ratio"] <= 1.0,
                  f"{what}: more useful FLOPs than counted")
            mf = rec["model_flops_global"]
        check(all(math.isfinite(v) and v > 0
                  for v in (vals["flops"], vals["bytes"], mf)),
              f"{what}: non-positive counts")
        check((vals["wire_bytes"] > 0) == (chips > 1),
              f"{what}: wire bytes {vals['wire_bytes']} on {chips} chips")
        log("dryrun_cell", arch=run["arch"], shape=run["shape"],
            accounting=run["accounting"], mesh=mesh, chips=chips,
            model_flops=mf, chip=chip.name, card=card, **vals)


def real_step(cfg, spec, dev, chip, card, log) -> None:
    """One step traced on ``meta`` and run on the card, both under the
    counter: the same FLOPs, the predicted peak within PEAK_RTOL of
    ``max_memory_allocated``; then its time (CUDA events, median of
    COST_TIMED after 2 warm-ups) beside its roofline bound and ``mfu``.
    The bound is ``report.terms``': the counted FLOPs and the analytic
    minimum of bytes (``roofline.analytic_hbm_bytes`` at one card, tp=1);
    the counted bytes (every eager op's operands, which fusing ops would
    shrink) give only the diagnostic ``counted_memory_s``."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    meta, pred = dryrun.count_step(*dryrun.step_call(cfg, spec, "meta"))
    gc.collect()   # earlier paths' garbage, or a collection in the step
    torch.cuda.empty_cache()   # would free it below the baseline
    base = torch.cuda.memory_allocated(dev)
    fn, args = dryrun.step_call(cfg, spec, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    card_c, _ = dryrun.count_step(fn, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(meta.flops == card_c.flops,
          f"{spec.kind}: meta FLOPs {meta.flops} != card {card_c.flops}")
    gap = (pred["peak_bytes"] - peak) / peak
    check(abs(gap) <= PEAK_RTOL,
          f"{spec.kind}: predicted peak {pred['peak_bytes']} vs "
          f"max_memory_allocated {peak} ({gap:+.3f})")
    for _ in range(2):
        fn()
    times = []
    for _ in range(COST_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    t_step = statistics.median(times)
    min_bytes = rf.analytic_hbm_bytes(cfg, spec, 1, tp=1)
    terms = rf.roofline_terms(card_c.flops, min_bytes, 0.0, chip)
    mf = rf.model_flops(cfg, spec)
    log("cost_step", kind=spec.kind, batch=spec.global_batch,
        seq=spec.seq_len, flops=card_c.flops, meta_flops=meta.flops,
        bytes=card_c.bytes, meta_bytes=meta.bytes, min_bytes=min_bytes,
        kernel_ops=card_c.kernel_ops, meta_kernel_ops=meta.kernel_ops,
        predicted_peak_bytes=pred["peak_bytes"], peak_bytes=peak,
        peak_gap=gap, step_s=t_step, step_s_all=times,
        bound_s=terms.bound_time_s, dominant=terms.dominant,
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        counted_memory_s=card_c.bytes / chip.hbm_bw,
        model_flops=mf, mfu=mf / (chip.peak_flops * t_step),
        bound_share=terms.bound_time_s / t_step, chip=chip.name, card=card)
    del fn, args


def extrapolation_check(cfg, spec, log) -> None:
    """``accounting_cell``'s two-depth extrapolation (depths 1 and 2, in
    accounting mode) against the full-depth trace on ``meta``: FLOPs and
    bytes within EXTRAP_RTOL (at these lengths the accounting mode's
    attention chunks are the default ones). Both traces run after
    ``real_step``'s, once the process's one-time copies (the RoPE table
    on each device) are made."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.accounting import accounting_cell
    full, _ = dryrun.count_step(*dryrun.step_call(cfg, spec, "meta"))
    SHAPES[spec.name] = spec
    try:
        acct = accounting_cell(cfg.name, spec.name)
    finally:
        del SHAPES[spec.name]
    for key, want in (("flops", full.flops), ("bytes", full.bytes)):
        err = abs(acct[key] - want) / want
        log("cost_extrapolation", kind=spec.kind, key=key, full=want,
            extrapolated=acct[key], rel_err=err, l1=acct["l1"],
            l2=acct["l2"])
        check(err <= EXTRAP_RTOL,
              f"{spec.kind}: extrapolated {key} off by {err:.2e}")


def check_hier_seeds(hier, qs, masks) -> None:
    """Each query's ``select_anchors`` through the hierarchy: every
    cluster it used matches the predicate in the flat atlas, and every
    seed passes the predicate, lies in a used cluster and comes once."""
    import numpy as np
    flat = hier.flat
    for qi, q in enumerate(qs):
        seeds, used = hier.select_anchors(q.vector, q.predicate, set())
        seeds = np.asarray(seeds, dtype=np.int64)
        check(bool(np.isin(used, flat.matching_clusters(q.predicate)).all()),
              f"hier[{qi}]: a used cluster does not match the predicate")
        check(np.unique(seeds).size == seeds.size, f"hier[{qi}]: dupes")
        check(bool(masks[qi][seeds].all()),
              f"hier[{qi}]: a seed fails its predicate")
        check(bool(np.isin(flat.assign[seeds], used).all()),
              f"hier[{qi}]: a seed outside the clusters used")


def hier_atlas_check(ds, index, batches, dev, card, log) -> None:
    """``HierAtlas`` over the main corpus: its device export is the flat
    atlas's; its anchor seeds hold to their predicates and clusters
    (``check_hier_seeds``); HIER_Q through the sequential ``run_queries``
    with each atlas returns ids that pass ``check_results``, with recall@10
    (hier > flat - HIER_RECALL_GAP) and the host anchor scoring time per
    query (each query's first ``select_anchors``)."""
    import numpy as np
    import torch

    from repro_torch.core.hier_atlas import HierAtlas
    from repro_torch.core.search import FiberIndex, SearchParams, run_queries
    from repro_torch.data.ground_truth import recall_at_k
    t = time.time()
    hier = HierAtlas.build(ds, index.atlas)
    build_s = time.time() - t
    got, want = hier.to_device(device=dev), index.atlas.to_device(device=dev)
    fields = [f for f in vars(want) if torch.is_tensor(getattr(want, f))]
    check(bool(fields) and all(torch.equal(getattr(got, f), getattr(want, f))
                               for f in fields) and got.v_cap == want.v_cap,
          "HierAtlas.to_device differs from the flat atlas's export")
    del got, want
    qs = batches[HIER_Q]
    gts, masks = ground_truth(ds, qs, dev)
    check_hier_seeds(hier, qs, masks)
    params = SearchParams(k=K, walk="guided", beam_width=2)
    out = {}
    for name, atlas in (("flat", index.atlas), ("hier", hier)):
        scoring = []
        for q in qs:
            t = time.perf_counter()
            atlas.select_anchors(q.vector, q.predicate, set(),
                                 vectors=ds.vectors)
            scoring.append(time.perf_counter() - t)
        t = time.time()
        ids, _ = run_queries(FiberIndex(ds.vectors, ds.metadata,
                                        index.graph, atlas), qs, params)
        check_results(f"hier_atlas/{name}", ids, masks)
        out[name] = dict(
            recall_at_10=float(np.mean([recall_at_k(i, g)
                                        for i, g in zip(ids, gts)])),
            search_s=time.time() - t,
            anchor_ms_per_query=float(np.median(scoring)) * 1e3)
    log("hier_atlas", n=ds.n, clusters=index.atlas.n_clusters,
        supers=int(hier.super_centroids.shape[0]), build_s=build_s,
        batch=HIER_Q, Q=len(qs), card=card, **{
            f"{k}_{name}": v for name, r in out.items()
            for k, v in r.items()})
    check(out["hier"]["recall_at_10"]
          > out["flat"]["recall_at_10"] - HIER_RECALL_GAP,
          f"hier recall {out['hier']['recall_at_10']:.3f} vs flat "
          f"{out['flat']['recall_at_10']:.3f}")


def cost_model_path(dry, ds, index, batches, dev, card, log) -> dict:
    """The cost model on the card: the dry-run records (``dry``, from
    ``DryRuns.join``; DRY_CELLS on the constants selected by the card's
    name); SmolLM-135M's train, prefill and decode steps held to their
    meta traces and to the two-depth extrapolation, timed against their
    roofline bound; and the hierarchical atlas on the main corpus. It
    launches none of K1-K5 (the sequential search runs on the host).
    Returns the path's launch counts."""
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import roofline as rf
    t_path = time.time()
    build.LAUNCHES.clear()
    chip = rf.chip_for(torch.cuda.get_device_name(dev))
    dry_records(dry, chip, card, log)
    cfg = get_config(COST_ARCH)
    for kind, seq, batch in COST_STEPS:
        spec = ShapeSpec(f"smoke_{kind}", seq, batch, kind)
        real_step(cfg, spec, dev, chip, card, log)
        extrapolation_check(cfg, spec, log)
        torch.cuda.empty_cache()
    hier_atlas_check(ds, index, batches, dev, card, log)
    launches = path_launches("cost_model", (), log)
    log("cost_model_path", s=time.time() - t_path)
    return launches


# the examples path: the port's user-facing scripts, loaded from their files
EXAMPLES_OVERLAP = 0.98     # card ids vs the same embeddings on the host
EXAMPLE_TRAIN_STEPS = 30    # train_lm's --steps here (its default is 60)


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module, its ``main`` not run."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_rag_serve(card, log) -> None:
    """``torch_rag_serve.py --full`` at its defaults on cuda:0 (SmolLM-135M
    whole, 2,048 documents, 32 queries): the first K1, K3 and WR calls held to
    their plain versions, ``retrieve``'s and ``retrieve_batch``'s ids
    checked against the predicate, and the card's embeddings searched
    again by a ``device="cpu"`` service over the same dataset, whose
    ``query_batch`` ids the card's must overlap by EXAMPLES_OVERLAP."""
    import numpy as np
    from repro_torch.core.search import SearchParams
    from repro_torch.serve.retrieval import RetrievalService
    mod = load_example("rag_serve")
    t = time.time()
    with FirstCalls() as seen:
        out = mod.main(["--full", "--device", "cuda:0"])
    run_s = time.time() - t
    check(set(seen) == set(SEARCH_KERNELS), f"examples: kernels never "
          f"called: {set(SEARCH_KERNELS) - set(seen)}")
    check_first_calls(seen, "examples/rag_serve", log)
    ds, pred = out["dataset"], out["predicate"]
    q = len(out["ids"])
    masks = [pred.mask(ds.metadata)] * q
    check_results("examples/rag_serve/sequential",
                  [np.asarray(r[0]) for r in out["sequential"]], masks)
    check_results("examples/rag_serve/batch", out["ids"], masks)
    t = time.time()
    host = RetrievalService.build(ds, graph_k=24, r_max=64,
                                  params=SearchParams(k=10), device="cpu")
    h_ids, _ = host.query_batch(out["query_vectors"], [pred] * q)
    host_s = time.time() - t
    ov = overlap(out["ids"], h_ids)
    log("examples_rag_serve", docs=ds.n, queries=q, s=run_s,
        index_s=out["index_s"],
        recall_at_10=out["recall"], recall_at_10_batch=out["recall_batch"],
        ms_per_query=out["ms_per_query"],
        ms_per_query_batch=out["ms_per_query_batch"],
        mean_restarts=out["mean_restarts"], host_overlap=ov,
        host_exact=float(np.mean([np.array_equal(a, b) for a, b in
                                  zip(out["ids"], h_ids)])),
        host_s=host_s, card=card)
    check(ov >= EXAMPLES_OVERLAP, f"examples: rag_serve card vs host id-set "
          f"overlap {ov:.4f} < {EXAMPLES_OVERLAP}")


def example_train_lm(card, log) -> None:
    """``torch_train_lm.py --full --steps EXAMPLE_TRAIN_STEPS`` on cuda:0
    into a temporary ``--ckpt-dir`` (a checkpoint at step 25), then again
    on that directory: the second run resumes from the newest checkpoint
    and ends at the same last step; the first run's last logged loss is
    below its first. Each checkpoint write is timed to its end."""
    import shutil
    import signal
    import tempfile

    from repro_torch.checkpoint import ckpt
    mod = load_example("train_lm")
    d = tempfile.mkdtemp(prefix="fns_example_ckpt_")
    real_save, saves = ckpt.save, []

    def timed_save(*args, **kw):
        t = time.time()
        handle = real_save(*args, **kw)
        if handle is not None:
            handle.wait()
        saves.append(time.time() - t)
        return handle

    sigs = (signal.SIGTERM, signal.SIGUSR1)
    kept = [signal.getsignal(s) for s in sigs]
    argv = ["--full", "--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", d,
            "--device", "cuda:0"]
    ckpt.save = timed_save
    try:
        t = time.time()
        first = mod.main(argv)
        first_s = time.time() - t
        newest = ckpt.latest_step(d)
        t = time.time()
        second = mod.main(argv)
        second_s = time.time() - t
    finally:
        ckpt.save = real_save
        for s, h in zip(sigs, kept):
            signal.signal(s, h)
        shutil.rmtree(d, ignore_errors=True)
    losses = [m["loss"] for m in first["metrics"]]
    log("examples_train_lm", steps=EXAMPLE_TRAIN_STEPS,
        logged_losses=losses, first_s=first_s, second_s=second_s,
        step_ms=statistics.median(
            first["step_times"][TRAIN_TIMED_FROM:]) * 1e3,
        first_step_s=first["step_times"][0], save_s=saves,
        newest_ckpt=newest, resumed_at=second["start"],
        resumed_losses=[m["loss"] for m in second["metrics"]], card=card)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"examples: train_lm's logged loss went {losses}")
    check(first["start"] == 0 and newest is not None
          and second["start"] == newest,
          f"examples: train_lm resumed at {second['start']}, the newest "
          f"checkpoint is {newest}")
    check(second["last_step"] == first["last_step"] == EXAMPLE_TRAIN_STEPS,
          f"examples: train_lm ended at {first['last_step']} and "
          f"{second['last_step']}")


def examples_path(card, log) -> dict:
    """The port's two LM examples on the card, in process, each loaded
    from its file: ``torch_rag_serve.py`` (K1/K3/WR) and
    ``torch_train_lm.py`` (none of K1-K5). The three host examples do no
    card work and are held line for line on the CPU. Returns the path's
    launch counts."""
    import torch
    from repro_torch.kernels import build
    t_path = time.time()
    build.LAUNCHES.clear()
    example_rag_serve(card, log)
    torch.cuda.empty_cache()
    example_train_lm(card, log)
    torch.cuda.empty_cache()
    launches = path_launches("examples", SEARCH_KERNELS, log)
    log("examples_path", s=time.time() - t_path)
    return launches


def run(report_path: str | None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import build

    report: dict = {"records": []}

    def log(what, **kw):
        rec = {"phase": what, **kw}
        report["records"].append(rec)
        print(json.dumps(rec), flush=True)

    card = card_line()
    log("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)
    t = time.time()
    # one thread per kernel, so the nvcc processes run side by side
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        list(pool.map(build.load, build.KERNELS))
    log("kernel_build", s=time.time() - t)
    for name in build.KERNELS:  # registers, shared memory, spills
        log("ptxas", kernel=name, report=build.ptxas_report(name))
    with SyncChecked() as synced:
        records, profile = drive_paths(dev, card, log, report_path)
    log("sync_checked", dispatches=synced.dispatches,
        collects=synced.collects)
    if report_path:
        report["profile"] = profile
        report["kernels"] = list(records.values())
        os.makedirs(os.path.dirname(os.path.abspath(report_path)),
                    exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, default=float)
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive_paths(dev, card, log, report_path):
    """Every path after the kernel build, in order; returns the kernel
    records (launches filled in from the paths' runs) and, with a report,
    the profile of one batch."""
    import torch
    dry = DryRuns()   # host traces beside the corpus build, joined after it
    try:
        ds, index, held = build_corpus(log)
        dry_runs = dry.join(log)
    finally:
        dry.close()
    batches = make_batches(ds)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    records = kernel_phases(ds, index, batches, dev, flush, log)
    del flush
    torch.cuda.empty_cache()
    by_path = {"parity_gate": parity_path(log)}
    profile = {} if report_path else None
    card_res, by_path["search"] = main_path(ds, index, batches, dev, card,
                                            log, profile)
    host_comparison(index, ds, batches, card_res, log)
    torch.cuda.empty_cache()
    by_path["live_index"] = live_index(ds, index, held, batches, dev, card,
                                       log)
    torch.cuda.empty_cache()
    mesh = Segments("mesh")
    by_path["sharded"] = sharded_path(ds, held, batches, card_res, dev, card,
                                      log, mesh)
    torch.cuda.empty_cache()
    by_path["serve"] = serve_path(ds, index, held, batches, card_res, dev,
                                  card, log, mesh)
    by_path["mesh"] = mesh.finish(SEARCH_KERNELS, log)
    del held, card_res   # the corpus stays for the cost model's atlas
    torch.cuda.empty_cache()
    lm_mesh = Segments("lm_mesh")   # its retrieval inside the rag path
    by_path["rag"] = rag_path(dev, card, log, lm_mesh)
    torch.cuda.empty_cache()
    lm_mesh.run(lambda: lm_mesh_path(dev, card, log))
    by_path["lm_mesh"] = lm_mesh.finish(SEARCH_KERNELS, log)
    torch.cuda.empty_cache()
    family_mesh_seg = Segments("family_mesh")   # inside the next two paths
    by_path["lm_families"] = lm_families_path(dev, card, log,
                                              family_mesh_seg)
    torch.cuda.empty_cache()
    family_train = Segments("family_train_mesh")   # inside the train path
    by_path["train"] = train_path(dev, card, log, family_mesh_seg,
                                  family_train)
    by_path["family_mesh"] = family_mesh_seg.finish(SEARCH_KERNELS, log)
    by_path["family_train_mesh"] = family_train.finish((), log)
    torch.cuda.empty_cache()
    train_mesh = Segments("train_mesh")
    train_mesh.run(lambda: train_mesh_path(dev, card, log))
    by_path["train_mesh"] = train_mesh.finish((), log)
    torch.cuda.empty_cache()
    by_path["cost_model"] = cost_model_path(dry_runs, ds, index, batches,
                                            dev, card, log)
    del ds, index, batches
    torch.cuda.empty_cache()
    by_path["examples"] = examples_path(card, log)
    # each kernel's launches come from the path it belongs to: K1, K3 and
    # WR from the search, K2, K4 and K5 from the parity gate
    for name, rec in records.items():
        path = "parity_gate" if name in GATE_KERNELS else "search"
        rec["launches"] = by_path[path].get(name, 0)
        rec["launches_by_path"] = {p: n.get(name, 0)
                                   for p, n in by_path.items()}
    return records, profile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", help="also write every measurement here")
    args = ap.parse_args()
    try:
        return run(args.report)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
