"""Render the roofline tables from the port's dry-run and accounting
records (``results/torch/dryrun``, ``results/torch/accounting``).

    PYTHONPATH=src python -m repro_torch.launch.report \
        [--mesh 1xH100|16x16|2x16x16] [--md]

The terms use the constants of the chip each record names (the port's
records carry ``"chip"``; ``roofline.chip_for`` resolves a card's name,
``terms(rec, chip)`` takes any row).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline as rf
from repro_torch.launch.dryrun import ACCT_DIR, DRYRUN_DIR, MESH


def load_cells(dryrun_dir=DRYRUN_DIR, acct_dir=ACCT_DIR):
    cells = {}
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        key = (r["arch"], r["shape"], r["mesh"])
        cells[key] = r
        tag = os.path.basename(p).replace(".json", "")
        ap = os.path.join(acct_dir, tag + ".json")
        if os.path.exists(ap):
            with open(ap) as f:
                r["accounting"] = json.load(f)
    return cells


def _chip(rec) -> rf.Chip:
    """The ``CHIPS`` row a record names; a record that names none of them
    (or no chip) raises rather than take another card's peaks."""
    for c in rf.CHIPS:
        if c.name == rec.get("chip"):
            return c
    raise ValueError(f"{rec['arch']} {rec['shape']}: no roofline constants "
                     f"for chip {rec.get('chip')!r}; known: "
                     f"{[c.name for c in rf.CHIPS]}")


def terms(rec, chip: rf.Chip | None = None):
    """Roofline terms preferring the extrapolated accounting numbers, on
    ``chip`` (default: the one the record names).

    memory_lo = analytic minimum HBM traffic; memory_hi = the counter's
    bytes (every unfused operand: an upper bound). The dominant call and
    roofline fraction use (compute, memory_lo, collective); memory_hi is a
    diagnostic column. The collective term prices a mesh record's
    node-network bytes (``network_bytes``) at the chip's node rate and
    the rest at its links'. ``mfu`` is the model FLOPs over the peak for
    the bound's time: the most the step could reach.
    """
    from repro_torch.configs.base import SHAPES, get_config
    chip = chip or _chip(rec)
    acct = rec.get("accounting")
    if acct:
        flops, byts, wire = acct["flops"], acct["bytes"], acct["wire_bytes"]
        network = acct.get("network_bytes", 0.0)
        src = "acct"
    else:
        flops, byts, wire = (rec["flops_per_chip"], rec["bytes_per_chip"],
                             rec["collectives"]["wire_bytes"])
        network = rec["collectives"].get("network_bytes", 0.0)
        src = "trace"
    cfg = get_config(rec["arch"])
    spec = SHAPES[rec["shape"]]
    mem_lo_b = rf.analytic_hbm_bytes(cfg, spec, rec["chips"],
                                     tp=min(16, rec["chips"]))
    comp = flops / chip.peak_flops
    mem_lo = mem_lo_b / chip.hbm_bw
    mem_hi = byts / chip.hbm_bw
    coll = rf.collective_s(wire, chip, network)
    dom = max((comp, "compute"), (mem_lo, "memory"), (coll, "collective"))[1]
    useful = rec["model_flops_global"] / max(flops * rec["chips"], 1.0)
    bound = max(comp, mem_lo, coll)
    mfu = rec["model_flops_global"] / (rec["chips"] * chip.peak_flops * bound)
    return dict(compute_s=comp, memory_s=mem_lo, memory_hi_s=mem_hi,
                collective_s=coll, dominant=dom, useful=useful, src=src,
                bound_s=bound, mfu=mfu,
                roofline_frac=comp / max(bound, 1e-30))


def render(mesh: str = MESH, md: bool = False,
           dryrun_dir: str = DRYRUN_DIR, acct_dir: str = ACCT_DIR) -> str:
    cells = load_cells(dryrun_dir, acct_dir)
    rows = []
    for (arch, shape, m), rec in sorted(cells.items()):
        if m != mesh:
            continue
        t = terms(rec)
        rows.append((arch, shape, t, rec))
    sep = " | " if md else " "
    lines = []
    hdr = (f"{'arch':<18}{sep}{'shape':<12}{sep}{'compute_s':>9}{sep}"
           f"{'mem_lo_s':>9}{sep}{'mem_hi_s':>9}{sep}{'coll_s':>9}{sep}"
           f"{'dominant':>10}{sep}{'useful':>7}{sep}{'MFU':>7}{sep}"
           f"{'roofline':>8}{sep}{'GiB/dev':>8}")
    lines.append(hdr)
    if md:
        lines.insert(0, "| " + hdr + " |")
    for arch, shape, t, rec in rows:
        peak = rec["memory"]["peak_bytes"] / 2**30
        line = (f"{arch:<18}{sep}{shape:<12}{sep}{t['compute_s']:>9.4f}{sep}"
                f"{t['memory_s']:>9.4f}{sep}{t['memory_hi_s']:>9.4f}{sep}"
                f"{t['collective_s']:>9.4f}{sep}"
                f"{t['dominant']:>10}{sep}{t['useful']:>7.3f}{sep}"
                f"{t['mfu']:>7.2%}{sep}"
                f"{t['roofline_frac']:>8.2%}{sep}{peak:>8.1f}")
        lines.append(line)
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default=MESH)
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="render the optimized-policy (auto) results")
    args = ap.parse_args(argv)
    if args.opt:
        print(render(args.mesh, args.md, f"{DRYRUN_DIR}_auto",
                     f"{ACCT_DIR}_auto"))
    else:
        print(render(args.mesh, args.md))


if __name__ == "__main__":
    main()
