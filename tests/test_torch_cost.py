"""The port's cost model held to the reference's on the CPU:
``models/settings.py`` (accounting mode), ``ArchConfig.input_specs``,
``launch/roofline.py`` (chip table, ring formulas, ``model_flops``,
``analytic_hbm_bytes``, ``_cache_bytes``, the step counter),
``launch/accounting.py``, ``launch/dryrun.py`` and ``launch/report.py``.

The arithmetic (FLOPs and bytes models, corrections, depths, policies,
report terms) must equal the reference's exactly for all ten archs and
their ``cell_plan`` shapes. Where a test needs the reference's TPU v5e
constants it reads them from ``repro.launch.roofline``: they are parity
inputs, not the port's figures. The counter's FLOPs, bytes, op count
and peak must be identical on ``meta`` tensors and on real CPU tensors;
the two-depth extrapolation must equal a full-depth trace within 1e-9
relative; the accounting switch must leave FLOPs unchanged and outputs
within fp32 summation order (1e-6).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs.base as ref_base
import repro.launch.accounting as ref_acct
import repro.launch.report as ref_report
import repro.launch.roofline as ref_rf
from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeSpec, cell_plan,
                                 get_config, reduced_config)
from repro_torch.launch import accounting, dryrun, report
from repro_torch.launch import roofline as rf
from repro_torch.models import attention, settings
from repro_torch.models.mamba import init_mamba, mamba_forward
from repro_torch.models.rwkv6 import init_rwkv_layer, rwkv_time_mix
from repro_torch.models.transformer import Tree, _MetaDraws

# the reference's TPU v5e constants, as a row of the port's table (parity
# input only; no memory figure: the terms do not read it)
V5E = rf.Chip("v5e (reference)", ref_rf.PEAK_FLOPS, ref_rf.HBM_BW,
              ref_rf.LINK_BW, ref_rf.N_LINKS, 0.0)
CELLS = {a: cell_plan(a) for a in ARCH_NAMES}
FAMILIES = ("smollm-135m", "dbrx-132b", "hymba-1.5b", "rwkv6-3b",
            "whisper-small", "internvl2-76b")
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module")
def ref_resolve_policy():
    """The reference's ``resolve_policy``. Its module sets a 512-device
    ``XLA_FLAGS`` when imported; the backend is started first (so it
    cannot take effect here) and the variable restored after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import resolve_policy
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return resolve_policy


def tiny(arch: str, **kw):
    """The arch's reduced config; whisper with room for decoder tokens
    (its reduced ``max_decode_len`` leaves none at a train shape)."""
    cfg = reduced_config(arch)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, max_decode_len=96)
    return dataclasses.replace(cfg, **kw)


# --- settings ----------------------------------------------------------------

def test_accounting_switch_keeps_flops_and_outputs():
    """Coarse blocks (2048/4096: one block here) against the default
    512/1024 (two query blocks): the same FLOPs, outputs within fp32
    summation order."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1024, 4, 32, generator=g)
    k = torch.randn(1, 1024, 2, 32, generator=g)
    v = torch.randn(1, 1024, 2, 32, generator=g)
    outs, flops = [], []
    for acct in (False, True):
        settings.UNROLL_SCANS = acct
        try:
            with rf.CostCounter() as c:
                outs.append(attention.chunked_attention(q, k, v, window=300))
        finally:
            settings.UNROLL_SCANS = False
        flops.append(c.flops)
    assert flops[0] == flops[1] > 0
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)


def test_accounting_switch_keeps_model_flops():
    """A prefill traced on meta at 4,096 tokens (8 x 4 blocks, or 2 x 1):
    the same FLOPs, fewer ops."""
    cfg = tiny("smollm-135m")
    spec = ShapeSpec("p", 4096, 2, "prefill")
    got = []
    for acct in (False, True):
        settings.UNROLL_SCANS = acct
        try:
            fn, args = dryrun.step_call(cfg, spec, "meta")
            got.append(dryrun.count_step(fn, args)[0])
        finally:
            settings.UNROLL_SCANS = False
    assert got[0].flops == got[1].flops
    assert got[1].kernel_ops < got[0].kernel_ops


# --- input specs -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    cfg, ref = get_config(arch), ref_base.get_config(arch)
    for shape in CELLS[arch]:
        want = ref.input_specs(shape)
        got = cfg.input_specs(shape)
        assert got.keys() == want.keys()
        for name, (shp, dt) in got.items():
            assert shp == want[name].shape, (shape, name)
            assert str(dt).removeprefix("torch.") == \
                np.dtype(want[name].dtype).name, (shape, name)
    spec = SHAPES[CELLS[arch][0]]
    assert cfg.input_specs(spec) == cfg.input_specs(spec.name)


# --- roofline ----------------------------------------------------------------

def test_chip_table_by_card_name():
    assert rf.chip_for("NVIDIA H100 80GB HBM3") is rf.H100_SXM
    assert rf.chip_for("NVIDIA H100 PCIe") is rf.H100_PCIE
    assert rf.H100_SXM.peak_flops == 989.4e12
    assert rf.H100_SXM.hbm_bw == 3.35e12
    assert rf.H100_SXM.n_links * rf.H100_SXM.link_bw == 18 * 25e9
    for other in ("NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB",
                  "NVIDIA H200"):
        with pytest.raises(ValueError, match="no roofline constants"):
            rf.chip_for(other)
    chip, mem = dryrun.target_chip("cpu")
    assert chip is rf.H100_SXM and mem == rf.H100_SXM.memory_bytes


@pytest.mark.parametrize("args", [(197e12, 100e9, 1e9), (1e9, 819e9 * 2, 1e9),
                                  (1e12, 1e9, 5e11), (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference(args):
    want = ref_rf.roofline_terms(*args)
    got = rf.roofline_terms(*args, chip=V5E)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.dominant, got.bound_time_s) == (want.dominant,
                                                want.bound_time_s)
    h = rf.roofline_terms(*args)   # the H100 SXM default
    assert h.compute_s == args[0] / 989.4e12


def test_wire_bytes_give_reference_hlo_numbers():
    """The reference test's HLO collectives, fed by hand as (kind, output
    bytes, group size)."""
    from test_roofline import HLO
    fed = [("all-reduce", 256 * 1024 * 2, 16),
           ("all-gather", 2 * 128 * 64 * 4, 8),
           ("reduce-scatter", 32 * 32 * 4, 4),
           ("all-to-all", 8 * 128 * 2, 4),
           ("collective-permute", 64 * 4, 2)]
    want = ref_rf.parse_collectives(HLO)
    got = {kind: rf.wire_bytes(kind, nb, n) for kind, nb, n in fed}
    assert got == want["by_kind"]
    assert sum(got.values()) == want["wire_bytes"]
    with pytest.raises(ValueError):
        rf.wire_bytes("broadcast", 8, 2)


def test_counter_applies_ring_costs_to_functional_collectives(tmp_path):
    """One gloo process: the counter sees each ``_c10d_functional``
    collective, counts it and prices it by the group's size (1 here)."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with rf.CostCounter() as c:
            fc.wait_tensor(fc.all_reduce(torch.ones(8, 4), "sum",
                                         dist.group.WORLD))
            fc.wait_tensor(fc.reduce_scatter_tensor(
                torch.ones(8, 4), "sum", 0, dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    assert c.coll_counts == {"all-reduce": 1, "reduce-scatter": 1}
    assert c.wire_bytes == 0.0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_flops_and_hbm_models_match_reference(arch):
    cfg, ref = get_config(arch), ref_base.get_config(arch)
    for shape in CELLS[arch]:
        spec, rspec = SHAPES[shape], ref_base.SHAPES[shape]
        assert rf.model_flops(cfg, spec) == ref_rf.model_flops(ref, rspec)
        assert rf.model_flops(cfg, spec, 77) == \
            ref_rf.model_flops(ref, rspec, 77)
        for n_chips, tp in ((256, 16), (512, 16), (1, 1), (4, 2)):
            assert rf.analytic_hbm_bytes(cfg, spec, n_chips, tp) == \
                ref_rf.analytic_hbm_bytes(ref, rspec, n_chips, tp)
        assert rf.analytic_hbm_bytes(cfg, spec, 256) == \
            ref_rf.analytic_hbm_bytes(ref, rspec, 256)
        for tp, dp in ((16, 16), (1, 1), (16, 256)):
            assert rf._cache_bytes(cfg, spec, tp, dp) == \
                ref_rf._cache_bytes(ref, rspec, tp, dp)


# --- the counter -------------------------------------------------------------

def _tiny_spec(kind: str) -> ShapeSpec:
    return ShapeSpec(f"tiny_{kind}", 32, 2, kind)


@pytest.mark.parametrize("arch", FAMILIES)
def test_counter_same_on_meta_and_real(arch):
    """Each family's train, prefill and decode step: FLOPs, bytes, op
    count and peak identical on meta stand-ins and on real CPU tensors
    (each device's RoPE table cached by a first run)."""
    cfg = tiny(arch)
    for kind in KINDS:
        spec = _tiny_spec(kind)
        got = {}
        for dev in ("meta", "cpu"):
            dryrun.count_step(*dryrun.step_call(cfg, spec, dev))
            counter, mem = dryrun.count_step(*dryrun.step_call(cfg, spec,
                                                               dev))
            got[dev] = (counter.costs(), mem)
        assert got["meta"] == got["cpu"], kind
        costs, mem = got["cpu"]
        assert costs["flops"] > 0 and costs["kernel_ops"] > 0
        assert mem["peak_bytes"] > mem["argument_bytes"] > 0


def test_counter_tracks_live_storage():
    """Peak = the most the new tensors held at once; in-place writes and
    views of earlier tensors add nothing."""
    x = torch.zeros(1024)                     # the caller's: not counted
    with rf.CostCounter() as c:
        a = torch.ones(256)                   # 1 KiB
        b = a * 2                             # 2 KiB live
        del a                                 # 1 KiB
        x.add_(1)                             # in place: nothing new
        v = x[:10]                            # a view: nothing new
        d = b + 1                             # 2 KiB live
    assert c.peak_bytes == 2048 and c.live_bytes == 2048
    assert c.kernel_ops == 4 and c.flops == 0
    assert c.bytes == 1024 + 2 * 1024 + 2 * 4096 + 2 * 1024
    del b, d, v


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_counter_counts_the_scan_contraction(family):
    """One forward of the recurrence on meta: the counter's FLOPs are the
    projections plus the step's contraction, the ``_COUNTED_SHARE`` of
    the reference's analytic per-token model, and nothing else."""
    B, S, d, N = 2, 64, 128, 16
    gen = _MetaDraws()
    x = torch.empty(B, S, d, device="meta", dtype=torch.bfloat16)
    if family == "hybrid":
        d_in, r = 2 * d, 8
        p = Tree(init_mamba(gen, d, d_in, N, r))
        with rf.CostCounter() as c:
            mamba_forward(p, x)
        proj = 2 * B * S * (d * 2 * d_in + d_in * (r + 2 * N) + r * d_in
                            + d_in * d)
        per_token = 9 * d_in * N
    else:
        p = Tree(init_rwkv_layer(gen, d, 4 * d, N))
        with rf.CostCounter() as c:
            rwkv_time_mix(p, x, None, N)
        proj = 2 * B * S * (5 * d * d + 2 * d * 64)
        per_token = 6 * d * N
    share = accounting._COUNTED_SHARE[family]
    assert c.flops == proj + share * per_token * B * S


# --- accounting --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_accounting_helpers_match_reference(arch, ref_resolve_policy):
    cfg, ref = get_config(arch), ref_base.get_config(arch)
    assert accounting._pattern_len(cfg) == ref_acct._pattern_len(ref)
    for ell in (1, 2, 6):
        assert dataclasses.asdict(accounting.reduced_depth(cfg, ell)) == \
            dataclasses.asdict(ref_acct.reduced_depth(ref, ell))
    for shape in CELLS[arch]:
        assert accounting._recurrent_correction_flops(cfg, shape) == \
            ref_acct._recurrent_correction_flops(ref, shape)
    for pol in ("tp", "zero1", "auto", "dp", "sp"):
        assert dryrun.resolve_policy(pol, cfg) == \
            ref_resolve_policy(pol, ref)


@pytest.mark.parametrize("arch,n_layers", [("smollm-135m", 5),
                                           ("gemma3-1b", 14),
                                           ("dbrx-132b", 3)])
def test_accounting_equals_full_depth_trace(arch, n_layers, monkeypatch):
    """l1, l2 as the reference picks them (gemma3: 6 and 12, extrapolated
    to 14, not a multiple of its period), against the full-depth trace in
    accounting mode: FLOPs and bytes within 1e-9 relative. gemma3's decode
    bytes are the exception the reference's average layer makes: its
    local layers' window mask moves a few bytes more than a global
    layer's, and 14 layers hold 2 globals, not 14/6."""
    cfg = tiny(arch, n_layers=n_layers)
    monkeypatch.setattr(accounting, "get_config", lambda name: cfg)
    for kind in KINDS:
        spec = _tiny_spec(kind)
        monkeypatch.setitem(SHAPES, spec.name, spec)
        settings.UNROLL_SCANS = True
        try:   # twice: the first run caches the RoPE table on meta
            accounting._trace_costs(cfg, spec.name, "tp")
            full = accounting._trace_costs(cfg, spec.name, "tp")
        finally:
            settings.UNROLL_SCANS = False
        got = accounting.accounting_cell(arch, spec.name)
        pat = ref_acct._pattern_len(ref_base.get_config(arch))
        assert (got["l1"], got["l2"]) == (pat, 2 * pat)
        assert got["flops"] == pytest.approx(full["flops"], rel=1e-9), kind
        if arch == "gemma3-1b" and kind == "decode":
            assert got["bytes"] != full["bytes"]
            assert got["bytes"] == pytest.approx(full["bytes"], rel=1e-4)
        else:
            assert got["bytes"] == pytest.approx(full["bytes"], rel=1e-9), \
                kind
        assert got["wire_bytes"] == 0.0 and got["coll_by_kind"] == {}
        assert not settings.UNROLL_SCANS


def test_accounting_adds_the_uncounted_recurrence(monkeypatch):
    """hymba's record: the extrapolated trace plus 7/9 of the reference's
    correction (mamba's elementwise step work); on the 2 x 16 x 16 mesh
    (``multi_pod=True``, as the reference calls it) that rest divided by
    its 512 chips, as the reference divides its correction."""
    cfg = tiny("hymba-1.5b")
    monkeypatch.setattr(accounting, "get_config", lambda name: cfg)
    spec = _tiny_spec("prefill")
    monkeypatch.setitem(SHAPES, spec.name, spec)
    corr = accounting._recurrent_correction_flops(cfg, spec.name)
    assert corr > 0
    for multi_pod, chips in ((False, 1), (True, 512)):
        got = accounting.accounting_cell("hymba-1.5b", spec.name,
                                         multi_pod=multi_pod)
        traced = got["flops_fixed"] + cfg.n_layers * got["flops_per_layer"]
        assert got["flops"] == pytest.approx(traced + corr * 7 / 9 / chips,
                                             rel=1e-12)
    assert (got["mesh"], got["chips"]) == ("2x16x16", 512)
    assert got["wire_bytes"] > 0 and got["coll_by_kind"]["all-reduce"] > 0


# --- dry-run -----------------------------------------------------------------

# the keys of the reference's ``lower_cell`` record
# (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s",
            "compile_s", "memory", "flops_per_chip", "bytes_per_chip",
            "collectives", "model_flops_global", "roofline"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_cell_reduced(arch, monkeypatch):
    """One reduced cell per family through ``lower_cell`` (kinds in
    turn): the reference's keys, one card, no collectives, the
    reference's model FLOPs, and the step's FLOPs as counted on real
    CPU tensors."""
    kind = KINDS[FAMILIES.index(arch) % 3]
    cfg = tiny(arch)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    spec = _tiny_spec(kind)
    monkeypatch.setitem(SHAPES, spec.name, spec)
    rec = dryrun.lower_cell(arch, spec.name, device="cpu")
    assert REF_KEYS <= rec.keys()
    assert (rec["mesh"], rec["chips"], rec["kind"]) == ("1xH100", 1, kind)
    assert rec["chip"] == "H100 SXM"
    assert rec["collectives"] == {"wire_bytes": 0.0, "by_kind": {},
                                  "counts": {}}
    ref_cfg = dataclasses.replace(ref_base.reduced_config(arch),
                                  max_decode_len=cfg.max_decode_len)
    assert rec["model_flops_global"] == ref_rf.model_flops(
        ref_cfg, ref_base.ShapeSpec(spec.name, 32, 2, kind))
    real, _ = dryrun.count_step(*dryrun.step_call(cfg, spec, "cpu"))
    assert rec["flops_per_chip"] == real.flops > 0
    mem = rec["memory"]
    assert mem["fits"] and mem["peak_bytes"] <= mem["capacity_bytes"]
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops_per_chip"] / rf.H100_SXM.peak_flops
    assert r["memory_s"] == rec["bytes_per_chip"] / rf.H100_SXM.hbm_bw
    assert r["dominant"] in ("compute", "memory")
    json.dumps(rec)


def test_dryrun_cli_records_and_failures(tmp_path, monkeypatch):
    cfg = tiny("smollm-135m")
    spec = _tiny_spec("decode")
    monkeypatch.setitem(SHAPES, spec.name, spec)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "dry"
    args = ["--arch", "smollm-135m", "--shape", spec.name, "--out",
            str(out), "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(args)
    assert e.value.code == 0
    rec = json.loads((out / f"smollm-135m__{spec.name}__single.json")
                     .read_text())
    assert rec["arch"] == "smollm-135m" and rec["memory"]["fits"]
    with pytest.raises(SystemExit) as e:     # a cached cell is skipped
        dryrun.main(args)
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:     # a failing cell: .err, exit 1
        dryrun.main(["--arch", "smollm-135m", "--shape", "no_such_shape",
                     "--out", str(out), "--device", "cpu"])
    assert e.value.code == 1
    assert (out / "smollm-135m__no_such_shape__single.json.err").exists()
    monkeypatch.setattr(accounting, "get_config", lambda name: cfg)
    with pytest.raises(SystemExit) as e:
        dryrun.main(args[:4] + ["--accounting", "--device", "cpu"])
    assert e.value.code == 0
    acct = json.loads((tmp_path / dryrun.ACCT_DIR
                       / f"smollm-135m__{spec.name}__single.json")
                      .read_text())
    assert acct["flops"] == pytest.approx(rec["flops_per_chip"], rel=1e-9)
    for mesh, tags in (("multi", ["multi"]), ("both", ["pod", "multi"])):
        with pytest.raises(SystemExit) as e:   # "both": multi cached
            dryrun.main(args + ["--mesh", mesh])
        assert e.value.code == 0
        for tag in tags:
            got = json.loads((out / f"smollm-135m__{spec.name}__{tag}.json")
                             .read_text())
            assert (got["mesh"], got["chips"]) == dryrun.MESHES[tag][:2]
            assert got["collectives"]["wire_bytes"] > 0
    rec = dryrun.lower_cell("smollm-135m", spec.name, multi_pod=True,
                            device="cpu")
    assert (rec["mesh"], rec["chips"]) == ("2x16x16", 512)


# --- report ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_report_terms_match_reference(arch):
    """A reference-mesh record (256 chips) of every cell, with and
    without accounting numbers: the port's terms on the reference's
    constants equal the reference's."""
    ref = ref_base.get_config(arch)
    rng = np.random.default_rng(len(arch))
    for shape in CELLS[arch]:
        rec = {"arch": arch, "shape": shape, "mesh": "16x16", "chips": 256,
               "flops_per_chip": float(rng.uniform(1e12, 1e15)),
               "bytes_per_chip": float(rng.uniform(1e9, 1e12)),
               "collectives": {"wire_bytes": float(rng.uniform(0, 1e10))},
               "model_flops_global": ref_rf.model_flops(
                   ref, ref_base.SHAPES[shape])}
        got, want = report.terms(rec, V5E), ref_report.terms(rec)
        # the counted step, where the reference read compiled HLO
        assert (got.pop("src"), want.pop("src")) == ("trace", "hlo-raw")
        assert got == want
        rec["accounting"] = {"flops": 3e14, "bytes": 2e11,
                             "wire_bytes": 4e9}
        assert report.terms(rec, V5E) == ref_report.terms(rec)


def test_report_renders_port_records(tmp_path, monkeypatch):
    """Records written by the dry-run CLI: loaded with their accounting,
    rendered on the chip they name; the one-card terms use tp=1 and
    ``mfu`` is the model FLOPs over the peak for the bound."""
    cfg = tiny("smollm-135m")
    spec = _tiny_spec("prefill")
    monkeypatch.setitem(SHAPES, spec.name, spec)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    rec = dryrun.lower_cell("smollm-135m", spec.name, device="cpu")
    d, a = tmp_path / "dry", tmp_path / "acct"
    d.mkdir()
    a.mkdir()
    tag = f"smollm-135m__{spec.name}__single.json"
    (d / tag).write_text(json.dumps(rec))
    (a / tag).write_text(json.dumps({"flops": 2.0 * rec["flops_per_chip"],
                                     "bytes": rec["bytes_per_chip"],
                                     "wire_bytes": 0.0}))
    cells = report.load_cells(str(d), str(a))
    got = cells[("smollm-135m", spec.name, "1xH100")]
    t = report.terms(got)
    assert t["src"] == "acct"
    assert t["compute_s"] == 2.0 * rec["flops_per_chip"] / 989.4e12
    real_cfg = get_config("smollm-135m")
    want_lo = rf.analytic_hbm_bytes(real_cfg, spec, 1, 1) / 3.35e12
    assert t["memory_s"] == want_lo
    assert t["mfu"] == rec["model_flops_global"] / (989.4e12 * t["bound_s"])
    table = report.render("1xH100", False, str(d), str(a))
    assert "smollm-135m" in table and spec.name in table
    assert report.render("16x16", False, str(d), str(a)).count("\n") == 0


@pytest.mark.parametrize("chip", ["H200", None])
def test_report_refuses_a_record_of_an_unknown_chip(chip):
    """A record that names no ``CHIPS`` row (or no chip) raises; it does
    not take the H100 SXM numbers."""
    rec = {"arch": "smollm-135m", "shape": "decode_32k", "chips": 1}
    if chip:
        rec["chip"] = chip
    with pytest.raises(ValueError, match="no roofline constants"):
        report.terms(rec)
