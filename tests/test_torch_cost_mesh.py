"""The cost model on a device mesh: a cell's collectives counted by the
``roofline.CostCounter`` of its thread (``launch/placement.py``), the
one-cell ``meta`` trace (``placement.cell_counters(..., trace=index)``)
against every cell of a real run, and the dry-run's 16 x 16 and
2 x 16 x 16 rows (``launch/dryrun.py --mesh pod|multi``,
``launch/accounting.py``) against the reference's ``lower_cell``.

The reference's production rows run in one subprocess with 512 virtual
CPU devices; its ``make_production_mesh`` builds ``Explicit`` axes,
which jax 0.9 refuses, so the subprocess swaps it for a mesh of the same
shape and names with ``Auto`` axes (``src/repro/`` is not changed). XLA
counts a scan body once and picks its own collectives (a hymba prefill
uses collective-permutes), so FLOPs a chip and collectives are logged
beside the reference's, not compared; the record's keys, mesh, chips,
kind and model FLOPs are equal, and so are a decode step's all-reduce
wire bytes (no scan there).

Exact: every cell's FLOPs, bytes, kernel ops and wire bytes and counts
by kind, real run against trace, for prefill, decode, the loss, the
dry-run's training step under dp and its sync and update under tp; that
step's new parameters, m and v against ``make_train_step``'s (without
clipping); one dense tp layer's wire bytes against the ring formula on
its row-parallel sums.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a process)
from repro_torch.configs import SHAPES, ShapeSpec, reduced_config
from repro_torch.launch import accounting, dryrun
from repro_torch.launch import placement as pl
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.common import pad_vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, S_ENC = 8, 16, 24
COUNT_CASES = {   # name -> (arch, mesh, policy)
    "dense": ("llama3.2-1b", (2, 4), "tp"),
    "dense_sp": ("llama3.2-1b", (2, 4), "sp"),
    "moe": ("dbrx-132b", (2, 4), "tp"),
    "hybrid": ("hymba-1.5b", (2, 4), "tp"),
    "ssm": ("rwkv6-3b", (1, 8), "tp"),
    "audio": ("whisper-small", (2, 4), "tp"),
}
# the reference's production rows: one reduced config a step kind, at a
# batch of 256 sequences of 32 tokens
ROW_CASES = {"train": "smollm-135m", "decode": "llama3.2-1b",
             "prefill": "hymba-1.5b"}
ROW_SEQ, ROW_BATCH = 32, 256


def _cfg(arch):
    """The reduced config (whisper with room for decoder tokens at a
    train shape, as ``tests/test_torch_cost.py`` makes it)."""
    cfg = reduced_config(arch)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, max_decode_len=96)
    return cfg


def _batch(cfg, device, labels=False):
    rng = np.random.default_rng(3)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(
            np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def _passes(cfg, env, placed, device):
    """Each pass a serving or training cell runs, as a callable: prefill
    into a cache with room for a token, a decode step on it, and the
    loss without its backward."""
    state = {}

    def pre():
        logits, state["cache"] = tf.prefill(placed, _batch(cfg, device), cfg,
                                            env, cache_len=S + 1)
        return logits

    def dec():
        tok = _batch(cfg, device)["tokens"][:, :1]
        return tf.decode_step(placed, state["cache"], {"tokens": tok}, cfg,
                              env)[0]

    def loss():
        with torch.no_grad():
            return tf.forward_loss(placed, _batch(cfg, device, True), cfg,
                                   env)

    return {"prefill": pre, "decode": dec, "loss": loss}


def _counts(c: rf.CostCounter) -> dict:
    return {"flops": c.flops, "bytes": c.bytes, "kernel_ops": c.kernel_ops,
            "wire": dict(c.coll_by_kind), "counts": dict(c.coll_counts)}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_one_cell_trace_equals_every_cell_of_a_real_run(case):
    """Every cell of a real run on a mesh of CPU cells, each counted by its
    own counter through ``run_cells``, against the ``meta`` trace of that
    cell alone: FLOPs, bytes, kernel ops, and wire bytes and collectives
    by kind equal exactly for prefill, a decode step and the loss (each
    device's RoPE table cached by a first run); the collectives are
    there and a cell's count is its own, not the mesh's."""
    arch, shape, pol = COUNT_CASES[case]
    cfg = _cfg(arch)
    got = {}
    for dev in ("cpu", "meta"):
        env = tf.ShardEnv(make_local_mesh(
            *shape, devices=[dev] * int(np.prod(shape))), policy=pol)
        placed = tf.place_params(tf.init_params(cfg, seed=1, device=dev),
                                 env)
        passes = _passes(cfg, env, placed, dev)
        for name, run in passes.items():
            run()    # warm: the RoPE table's copy to the device
        for name, run in passes.items():
            if name == "decode":
                passes["prefill"]()   # a fresh cache
            if dev == "cpu":
                with pl.cell_counters(rf.CostCounter) as cs:
                    run()
                got[dev, name] = {i: _counts(c) for i, c in cs.items()}
                continue
            got[dev, name] = {}
            for index in np.ndindex(*shape):
                if name == "decode":
                    passes["prefill"]()
                with pl.cell_counters(rf.CostCounter, trace=index) as cs:
                    run()
                assert list(cs) == [index]
                got[dev, name][index] = _counts(cs[index])
    for name in ("prefill", "decode", "loss"):
        real, traced = got["cpu", name], got["meta", name]
        assert real.keys() == traced.keys()
        for index in real:
            assert real[index] == traced[index], (name, index)
        assert real[(0,) * len(shape)]["counts"], name
    one = got["cpu", "prefill"][(0,) * len(shape)]["flops"]
    assert one < sum(c["flops"] for c in got["cpu", "prefill"].values())


def test_dense_tp_layer_wire_bytes_are_its_row_parallel_sums():
    """llama3.2-1b (reduced) on 2 x 4 tp: one layer's more in a prefill
    trace adds exactly two all-reduces (``wo``'s and ``w_down``'s
    partials, each the cell's batch block of the bf16 residual stream
    over the 4 model cells) of ``wire_bytes("all-reduce", ...)``; the
    vocab-split logits add one all-gather, whatever the depth."""
    base = _cfg("llama3.2-1b")
    mesh = make_local_mesh(2, 4, devices=["meta"] * 8)
    env = tf.ShardEnv(mesh)
    out = {}
    for layers in (1, 2):
        cfg = dataclasses.replace(base, n_layers=layers)
        placed = tf.place_params(tf.init_params(cfg, device="meta"), env)
        batch = _batch(cfg, "meta")
        tf.prefill(placed, batch, cfg, env)
        with pl.cell_counters(rf.CostCounter, trace=(1, 2)) as cs:
            tf.prefill(placed, batch, cfg, env)
        out[layers] = cs[1, 2]
    psum = rf.wire_bytes("all-reduce", (B // 2) * S * base.d_model * 2, 4)
    assert out[2].coll_by_kind["all-reduce"] - \
        out[1].coll_by_kind["all-reduce"] == 2 * psum
    assert out[1].coll_by_kind["all-reduce"] == 2 * psum
    assert out[1].coll_counts == {"all-reduce": 2, "all-gather": 1}
    assert out[2].coll_counts == {"all-reduce": 4, "all-gather": 1}
    assert out[1].coll_network == {}     # 8 cells: one node


def test_a_group_across_nodes_is_priced_at_the_node_rate():
    """On 16 x 16 a model group of 16 cells spans two nodes of 8: its
    wire bytes are network bytes, priced at the node rate in the
    collective term; on one node they go at the links' rate."""
    mesh = dryrun.meta_mesh("pod")
    x = torch.empty(4, 8, device="meta")
    c = rf.CostCounter()
    with c:
        pl.TraceCell(mesh, (3, 5)).psum(x, "model")
    w = rf.wire_bytes("all-reduce", 4 * 8 * 4, 16)
    assert c.coll_by_kind == {"all-reduce": w} and c.network_bytes == w
    chip = rf.H100_SXM
    assert rf.collective_s(w, chip, w) == w / chip.node_bw
    assert rf.collective_s(w, chip) == w / (chip.n_links * chip.link_bw)
    c = rf.CostCounter()
    with c:
        pl.TraceCell(make_local_mesh(2, 4, devices=["meta"] * 8),
                     (1, 1)).all_gather(x, "model", 0)
    assert c.network_bytes == 0.0
    assert c.coll_by_kind == {"all-gather": rf.wire_bytes(
        "all-gather", 4 * 4 * 8 * 4, 4)}


def test_traced_backward_reports_the_adjoint_collectives():
    """A traced cell's backward: a psum's adjoint is an all-reduce of the
    gradient, an all-gather's a reduce-scatter onto the block, an
    all_to_all's an all_to_all, each of its own bytes."""
    mesh = make_local_mesh(2, 4, devices=["meta"] * 8)
    cell = pl.TraceCell(mesh, (0, 1))
    x = torch.empty(2, 6, device="meta", requires_grad=True)
    c = rf.CostCounter()
    with c:
        y = cell.psum(x, "model") + cell.all_gather(x, "data", 0)[:2]
        y = y + cell.all_to_all(x.reshape(2, 1, 6), "data").reshape(2, 6)
        torch.autograd.grad(y.sum(), x)
    n = 2 * 6 * 4
    assert c.coll_counts == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 2}
    assert c.coll_by_kind["reduce-scatter"] == rf.wire_bytes(
        "reduce-scatter", n, 2)
    assert c.coll_by_kind["all-gather"] == rf.wire_bytes("all-gather", 2 * n,
                                                         2)


# -- the training step a cell runs ---------------------------------------------

# (arch, ZeRO-1, grad sync, clip norm): the dry-run's train step on a real
# 2 x 4 dp mesh. Without clipping the step's numbers equal
# make_train_step's bit for bit; with it (1.0, the default) the clip scale
# comes from a norm whose squares are summed in another order
# (``cell_update``), and they agree within STEP_REL of a leaf's largest.
DP_STEP_CASES = {
    "dense_z1": ("llama3.2-1b", True, "f32", 1e9),
    "dense": ("llama3.2-1b", False, "f32", 1e9),
    "dense_z1_bf16_clip": ("llama3.2-1b", True, "bf16", 1.0),
    "hybrid_z1": ("hymba-1.5b", True, "f32", 1e9),
    "ssm_z1_clip": ("rwkv6-3b", True, "f32", 1.0),
    "audio_z1": ("whisper-small", True, "bf16", 1e9),
}
# (arch, mesh, ZeRO-1, grad sync, clip norm): cell_update on real tp
# meshes, fed the partials of the port's own backward
TP_UPDATE_CASES = {
    "dense_z1": ("llama3.2-1b", (2, 4), True, "f32", 1e9),
    "dense_clip": ("llama3.2-1b", (2, 4), False, "f32", 1.0),
    "hybrid_z1_bf16": ("hymba-1.5b", (2, 4), True, "bf16", 1e9),
    "ssm_1x8_z1": ("rwkv6-3b", (1, 8), True, "f32", 1e9),
    "audio_z1_clip": ("whisper-small", (2, 4), True, "f32", 1.0),
}
STEP_REL = 1e-6


def _train_setup(arch, shape, pol, zero1, dev):
    from repro_torch.launch.shardings import opt_shardings
    from repro_torch.optim import adamw
    cfg = _cfg(arch)
    env = tf.ShardEnv(make_local_mesh(
        *shape, devices=[dev] * int(np.prod(shape))), policy=pol)
    placed = tf.place_params(tf.init_params(cfg, seed=1, device=dev), env)
    opt = adamw.init_opt_state(placed, opt_shardings(
        cfg, env.mesh, {"m": placed, "v": placed, "step": torch.zeros(())},
        pol, zero1))
    return cfg, env, placed, opt


def _same_state(got, new_params, new_opt, index, exact):
    """A cell's ``cell_update`` result against ``make_train_step``'s new
    parameters and state at that cell."""
    from repro_torch.optim import adamw
    want = {"params": adamw.leaves(new_params),
            "m": adamw.leaves(new_opt["m"]), "v": adamw.leaves(new_opt["v"])}
    for what, ref in want.items():
        assert len(got[what]) == len(ref)
        for i, (a, b) in enumerate(zip(got[what], ref)):
            b = b.shards[index]
            assert (a is None) == (b is None), (what, i, index)
            if a is None:
                continue
            if exact:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                err = float((a.double() - b.double()).abs().max())
                assert err <= STEP_REL * max(float(b.abs().max()), 1e-30), \
                    (what, i, index, err)


@pytest.mark.parametrize("case", list(DP_STEP_CASES))
def test_mesh_train_step_is_make_train_step_in_dp(case):
    """The dry-run's training step (``dryrun._mesh_train_step``: each
    cell's backward from its own loss, then ``cell_update``'s sync onto
    its blocks of m / v, update and all-gather) on a real 2 x 4 CPU mesh
    under dp, where each cell's pass is its own: every cell's new
    parameter, m and v blocks equal ``make_train_step``'s (one backward
    over the cells' graph, ``psum_partials``, ``adamw_update``) bit for
    bit without clipping, within STEP_REL with it; the grad norm within
    STEP_REL. Then each cell's count of that step (under
    ``cell_counters``) equals the ``meta`` trace of that cell alone."""
    from repro_torch.optim import adamw
    arch, zero1, sync, clip = DP_STEP_CASES[case]
    ocfg = adamw.AdamWConfig(grad_sync_dtype=sync, clip_norm=clip,
                             warmup_steps=1)
    got = {}
    for dev in ("cpu", "meta"):
        cfg, env, placed, opt = _train_setup(arch, (2, 4), "dp", zero1, dev)
        batch = _batch(cfg, dev, labels=True)

        def step():
            return dryrun._mesh_train_step(cfg, env, placed, opt, batch,
                                           ocfg)
        step()   # warm: the RoPE table's copy to the device
        if dev == "cpu":
            new_p, new_o, metrics = adamw.make_train_step(cfg, env, ocfg)(
                placed, opt, batch)
            with pl.cell_counters(rf.CostCounter) as cs:
                out = step()
            for index in np.ndindex(2, 4):
                loss, res = out[index]
                _same_state(res, new_p, new_o, index, exact=clip > 1e6)
                assert float(res["grad_norm"]) == pytest.approx(
                    float(metrics["grad_norm"]), rel=STEP_REL)
            got[dev] = {i: _counts(c) for i, c in cs.items()}
            continue
        got[dev] = {}
        for index in np.ndindex(2, 4):
            with pl.cell_counters(rf.CostCounter, trace=index) as cs:
                step()
            got[dev][index] = _counts(cs[index])
    assert got["cpu"] == got["meta"]
    kinds = got["cpu"][0, 0]["counts"]
    assert kinds["all-reduce"] >= 1
    assert ("reduce-scatter" in kinds) == ("all-gather" in kinds) == zero1


@pytest.mark.parametrize("case", list(TP_UPDATE_CASES))
def test_cell_update_is_make_train_steps_update_in_tp(case):
    """Under tp the cells' passes are joined by collectives, and the port's
    one backward crosses them, so ``cell_update`` is fed that backward's
    partials (``adamw.cell_partials``) on a real CPU mesh: every cell's
    new parameter, m and v blocks equal ``make_train_step``'s bit for bit
    without clipping, within STEP_REL with it; and each cell's count of
    the update equals the ``meta`` trace of that cell alone fed partials
    of the same shapes."""
    from repro_torch.optim import adamw
    arch, shape, zero1, sync, clip = TP_UPDATE_CASES[case]
    ocfg = adamw.AdamWConfig(grad_sync_dtype=sync, clip_norm=clip,
                             warmup_steps=1)
    cfg, env, placed, opt = _train_setup(arch, shape, "tp", zero1, "cpu")
    batch = _batch(cfg, "cpu", labels=True)
    new_p, new_o, _ = adamw.make_train_step(cfg, env, ocfg)(placed, opt,
                                                            batch)
    _, parts = adamw.cell_partials(
        lambda p: tf.forward_loss(p, batch, cfg, env), placed)

    def update(cell, placed, opt, parts):
        return adamw.cell_update(cell, placed, adamw.leaves(placed.local(
            cell)), [p[cell.index] for p in parts], opt, ocfg)
    with pl.cell_counters(rf.CostCounter) as cs:
        out = pl.run_cells(env.mesh, lambda c: update(c, placed, opt, parts))
    for index in np.ndindex(*shape):
        _same_state(out[index], new_p, new_o, index, exact=clip > 1e6)
    real = {i: _counts(c) for i, c in cs.items()}
    _, menv, mplaced, mopt = _train_setup(arch, shape, "tp", zero1, "meta")
    for index in np.ndindex(*shape):
        mparts = []
        for p, m in zip(parts, adamw.leaves(mplaced)):
            blk = m.shards[index]
            x = np.empty(shape, dtype=object)
            x[index] = None if p[index] is None else torch.empty_like(blk)
            mparts.append(x)
        with pl.cell_counters(rf.CostCounter, trace=index) as ms:
            pl.run_cells(menv.mesh, lambda c: update(c, mplaced, mopt,
                                                     mparts))
        assert _counts(ms[index]) == real[index], index


# -- the production rows ------------------------------------------------------

ROW_SCRIPT = """
    import sys; sys.path.insert(0, "src")
    import json
    import dataclasses
    import repro.launch.dryrun as D          # sets 512 host devices
    import jax
    from jax.sharding import AxisType
    from repro.configs import base

    def auto_mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    D.make_production_mesh = auto_mesh
    out = {}
    for kind, arch in json.loads(sys.argv[2]).items():
        name = "row_" + kind
        base.SHAPES[name] = base.ShapeSpec(name, int(sys.argv[3]),
                                           int(sys.argv[4]), kind)
        cfg = base.reduced_config(arch)
        D.get_config = lambda _, cfg=cfg: cfg
        for multi in (False, True):
            out[f"{kind}|{multi}"] = D.lower_cell(arch, name, multi)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, default=float)
    print("reference ok")
"""


@pytest.fixture(scope="module")
def ref_rows(tmp_path_factory):
    path = tmp_path_factory.mktemp("rows") / "rows.json"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(ROW_SCRIPT), str(path),
         json.dumps(ROW_CASES), str(ROW_SEQ), str(ROW_BATCH)], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", list(ROW_CASES))
def test_production_rows_match_reference(ref_rows, kind, monkeypatch):
    """``lower_cell`` on 16 x 16 (``mesh="pod"``) and 2 x 16 x 16
    (``multi_pod=True``) for a reduced config of each step kind against
    the reference's ``lower_cell``: the reference's keys (and those of
    its ``collectives`` and ``roofline``), mesh, chips, kind and model
    FLOPs equal; FLOPs a chip and collectives by kind printed beside the
    reference's; ``useful_flops_ratio`` at most 1, and the 512-chip
    row's FLOPs a chip below the 256-chip row's. A decode step has no
    scan: its all-reduce wire bytes equal the reference's, and its only
    other collective is the gather of the vocab-split logits."""
    arch = ROW_CASES[kind]
    cfg = reduced_config(arch)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    name = "row_" + kind
    monkeypatch.setitem(SHAPES, name, ShapeSpec(name, ROW_SEQ, ROW_BATCH,
                                                kind))
    got = {}
    for multi in (False, True):
        want = ref_rows[f"{kind}|{multi}"]
        rec = (dryrun.lower_cell(arch, name, multi_pod=True, device="cpu")
               if multi else
               dryrun.lower_cell(arch, name, mesh="pod", device="cpu"))
        assert want.keys() <= rec.keys()
        for key in ("collectives", "roofline"):
            assert want[key].keys() <= rec[key].keys(), key
        for key in ("mesh", "chips", "kind", "arch", "shape"):
            assert rec[key] == want[key], key
        assert rec["model_flops_global"] == pytest.approx(
            want["model_flops_global"], rel=1e-12)
        assert 0 < rec["roofline"]["useful_flops_ratio"] <= 1.0
        assert rec["collectives"]["wire_bytes"] > 0
        if kind == "decode":   # no scan: the reference's sums are the port's
            port, ref = rec["collectives"]["by_kind"], \
                want["collectives"]["by_kind"]
            assert set(ref) == {"all-reduce"}
            assert port["all-reduce"] == ref["all-reduce"]
            # and the port gathers the vocab-split fp32 logits of its
            # batch block over the 16 model cells, where the reference
            # leaves them split
            rows = ROW_BATCH // (rec["chips"] // 16)
            logits = rows * pad_vocab(cfg.vocab_size) * 4
            assert {k: v for k, v in port.items() if k != "all-reduce"} \
                == {"all-gather": rf.wire_bytes("all-gather", logits, 16)}
        print(f"\n{arch} {kind} {rec['mesh']}: flops/chip port "
              f"{rec['flops_per_chip']:.4g} reference "
              f"{want['flops_per_chip']:.4g}; wire by kind port "
              f"{rec['collectives']['by_kind']} "
              f"{rec['collectives']['counts']} reference "
              f"{want['collectives']['by_kind']} "
              f"{want['collectives']['counts']}")
        got[multi] = rec
    assert got[True]["flops_per_chip"] < got[False]["flops_per_chip"]


def test_accounting_on_both_meshes(monkeypatch):
    """``accounting_cell`` on 16 x 16 and 2 x 16 x 16: the two-depth
    extrapolation of each kind's wire bytes equals a full-depth trace of
    the same mesh exactly (the reduced llama's 2 layers: l1, l2 = 1, 2),
    and the node-network share is all of it (every group of 16 spans
    two nodes)."""
    cfg = reduced_config("llama3.2-1b")
    monkeypatch.setattr(accounting, "get_config", lambda name: cfg)
    spec = ShapeSpec("acct_train", 16, 32, "train")
    monkeypatch.setitem(SHAPES, spec.name, spec)
    for mesh, chips in (("pod", 256), ("multi", 512)):
        got = accounting.accounting_cell("llama3.2-1b", spec.name, mesh=mesh)
        full, _ = dryrun.trace_mesh_cell(cfg, spec, dryrun.meta_mesh(mesh))
        assert (got["mesh"], got["chips"]) == dryrun.MESHES[mesh][:2]
        assert got["flops"] == pytest.approx(full["flops"], rel=1e-9)
        for kind, w in full["coll_by_kind"].items():
            assert got["coll_by_kind"][kind] == pytest.approx(w, rel=1e-9)
        assert got["network_bytes"] == pytest.approx(got["wire_bytes"],
                                                     rel=1e-12)
