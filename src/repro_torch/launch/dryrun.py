"""Multi-pod dry run: count every (architecture x shape x mesh) cell on
the production meshes; record memory, counted cost and the sync census.

The meshes are slot meshes whose 256 (16x16) or 512 (2x16x16) slots are
all the ``meta`` device (``launch.mesh.make_production_mesh``): every
tensor has a shape and a dtype and no storage, so a full-size cell needs
no memory.  Each cell (``launch.cells.build_cell``) runs once under
``launch.op_analysis.analyze_ops``, which counts the executed ops: the
matrix products' flops and every op's bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \\
        --cell decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out dryrun_results/
    PYTHONPATH=src python -m repro_torch.launch.dryrun --stencil-plans
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --stencil-calibrate [--calibration-out r.json] [--device cpu]

``REPRO_MICROBATCHES`` splits each dp group's slice of a train cell's
batch, as in the reference.

A record keeps the reference's keys that ``launch/roofline.py`` and a
reader of its records use: ``arch``, ``cell``, ``mesh``, ``devices``
(slots), ``memory``, ``model_flops_global``, ``params`` and
``roofline``.  Where it differs, and why:

  * ``count_s`` (the counted run) stands where the reference writes
    ``lower_s`` and ``compile_s``; nothing is lowered or compiled, and
    there is no ``hlo_bytes``;
  * ``op_cost`` (the ``OpCost`` fields) stands for ``xla_cost`` and
    ``hlo_cost``: executed ops, a Python loop counted once a trip, where
    the reference parses loop-aware HLO;
  * ``census``: ``train_step.sync_counts``, ``rules.tp_counts`` and
    ``rules.constraint_counts`` of the run — the gathers, reductions,
    scatters and tensor-parallel transfers that would cross between
    cards, and each activation constraint by call site — with
    ``gather_groups``, the dp groups that gather the parameters, and
    ``gather_copies``, the distinct devices among them.  A step gathers
    once a distinct device, and every ``meta`` slot is one device, so
    the counted gather is one group's; a mesh of cards gathers once a
    group, and :func:`wire_bytes` counts it so.  A reduction already
    counts every group's gradient, and the scatter every unique block
    once (the mesh's whole);
  * ``memory``: ``argument_bytes`` and ``output_bytes`` are the largest
    slot's bytes under the cell's placements (a leaf without one counts
    whole; a mesh serve state's caches, the largest group's);
    ``temp_bytes`` and ``generated_code_bytes`` are ``None``: a run on
    ``meta`` allocates nothing that could be measured.

The roofline terms are per device: the counted global figure divided by
the slots, a mean (the census's whole calls show where the work is
uneven), over the H100 SXM5 data sheet: compute at the rate of the
config's ``compute_dtype`` (bf16 dense tensor cores 989 TFLOP/s, f32
``H100_SXM.peak_flops``), bytes at ``H100_SXM.hbm_bw``, the census's
wire bytes at ``H100_SXM.ici_bw`` (NVLink, each way).  The reference's
``--save-hlo`` has no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, cells_for, get_config
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.cells import MODEL_FLOPS, build_cell
from repro_torch.launch.mesh import H100_SXM, DeviceMesh, \
    make_production_mesh
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.sharding import rules
from repro_torch.sharding.placement import Placed, spec_axes
from repro_torch.train import train_step as ts
from repro_torch.train.serve_step import ServeState, serving_groups

__all__ = ["H100_BF16_FLOPS", "run_cell", "wire_bytes", "main"]

#: H100 SXM5 data sheet, dense bf16 on the tensor cores (700 W)
H100_BF16_FLOPS = 989e12

_PEAK = {"bfloat16": H100_BF16_FLOPS, "float32": H100_SXM.peak_flops}


def _leaf_bytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * \
        torch.empty((), dtype=dtype).element_size()


def _local_bytes(leaf, sharding) -> int:
    """One slot's bytes of ``leaf`` placed by ``sharding`` (whole when
    ``sharding`` is ``None``)."""
    if not isinstance(leaf, torch.Tensor):
        return 0
    shape = list(leaf.shape)
    if sharding is not None:
        sizes = sharding.mesh.axis_sizes()
        for j, entry in enumerate(sharding.spec):
            shape[j] //= int(np.prod([sizes[a] for a in spec_axes(entry)]))
    return _leaf_bytes(shape, leaf.dtype)


def _argument_bytes(args, shardings) -> int:
    return sum(v for tree, sh in zip(args, shardings)
               for _, v in rules.tree_items(
                   rules.tree_map(_local_bytes, tree, sh)))


def _held_bytes(tree) -> int:
    """One slot's bytes of a result tree: a placed leaf's block, any
    other tensor whole."""
    total = 0
    for _, x in rules.tree_items(tree):
        if isinstance(x, Placed):
            total += _leaf_bytes(x.local_shape, x.dtype)
        elif isinstance(x, torch.Tensor):
            total += _leaf_bytes(x.shape, x.dtype)
    return total


def _output_bytes(out) -> int:
    total = 0
    for x in out:
        if isinstance(x, ServeState):       # one list of caches a group
            total += max(_held_bytes(g) for g in x.caches)
        else:
            total += _held_bytes(x)
    return total


def _census(mesh: DeviceMesh, kind: str, rows: int) -> dict:
    groups = ts.dp_groups(mesh)
    if kind != "train":                 # the serving groups that run
        groups = groups[:serving_groups(mesh, rows)]
    return {"sync": dict(ts.sync_counts),
            "gather_groups": len(groups),
            "gather_copies": len({ts._device_key(d) for d in groups}),
            "tp": {k: dict(v) for k, v in rules.tp_counts.items()},
            "constraints": dict(sorted(rules.constraint_counts.items()))}


def wire_bytes(census: dict) -> int:
    """The bytes a census says would cross between cards: the counted
    gather once a dp group that gathers (module docstring)."""
    sync = census["sync"]
    gather = sync["gather_bytes"] * census["gather_groups"] \
        // census["gather_copies"]
    return int(gather + sync["reduction_bytes"]
               + sync["scatter_bytes"]
               + sum(c["sent_bytes"] + c["returned_bytes"]
                     for c in census["tp"].values()))


def run_cell(arch: str, cell_name: str, multi_pod: bool,
             ce_chunk: int = 512, microbatches: int = 1) -> dict:
    """Count one cell on the production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    cell = cells_mod.SHAPE_CELLS[cell_name]
    record = {"arch": arch, "cell": cell_name, "mesh": mesh.describe(),
              "devices": mesh.size}
    spec = build_cell(arch, cell_name, mesh, cfg=cfg, ce_chunk=ce_chunk,
                      microbatches=microbatches)
    ts.reset_sync_counts()
    rules.reset_tp_counts()
    rules.reset_constraint_counts()
    t0 = time.perf_counter()
    with rules.activate(mesh):
        out, cost = analyze_ops(spec.fn, *spec.args)
    count_s = time.perf_counter() - t0
    census = _census(mesh, cell.kind, cell.global_batch)

    n_dev = mesh.size
    record.update({
        "count_s": round(count_s, 2),
        "memory": {
            "argument_bytes": _argument_bytes(spec.args, spec.in_shardings),
            "output_bytes": _output_bytes(out),
            "temp_bytes": None,
            "generated_code_bytes": None,
        },
        "op_cost": dataclasses.asdict(cost),
        "census": census,
        "model_flops_global": MODEL_FLOPS(cfg, cell),
        "params": cfg.param_count(),
    })

    # roofline terms (per device: the global count over the slots)
    hw = H100_SXM
    terms = {
        "compute_s": cost.dot_flops / n_dev / _PEAK[cfg.compute_dtype],
        "memory_s": cost.traffic_bytes / n_dev / hw.hbm_bw,
        "collective_s": wire_bytes(census) / n_dev / hw.ici_bw,
    }
    record["roofline"] = dict(terms, bound=max(terms, key=terms.get))
    mf_per_dev = record["model_flops_global"] / n_dev
    record["roofline"]["model_flops_per_dev"] = mf_per_dev
    record["roofline"]["useful_ratio"] = (
        mf_per_dev / (cost.dot_flops / n_dev) if cost.dot_flops else None)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--stencil-plans", action="store_true",
                    help="print the stencil planner's PAPER_SUITE report "
                         "(modelled roofline decisions) and exit")
    ap.add_argument("--stencil-calibrate", action="store_true",
                    help="measure the stencil calibration suite and emit "
                         "the CalibrationRecord JSON (the serializer "
                         "launch.calibrate uses, so the output feeds "
                         "plan(calibration=...) and plan_report "
                         "--calibration directly)")
    ap.add_argument("--calibration-out", default=None, metavar="JSON_PATH",
                    help="with --stencil-calibrate: write the record here "
                         "instead of stdout")
    ap.add_argument("--device", default="cuda",
                    help="with --stencil-calibrate: where to measure")
    args = ap.parse_args(argv)

    if args.stencil_plans:
        from repro_torch.launch.plan_report import generate_report
        print(generate_report(), end="")
        return 0
    if args.stencil_calibrate:
        from repro_torch.launch.calibrate import calibrate_suite
        text = calibrate_suite(wall=True, device=args.device).to_json(
            indent=1)
        if args.calibration_out:
            with open(args.calibration_out, "w") as f:
                f.write(text)
            print(f"wrote {args.calibration_out}")
        else:
            print(text)
        return 0

    microbatches = int(os.environ.get("REPRO_MICROBATCHES", "1"))
    os.makedirs(args.out, exist_ok=True)
    jobs = []
    if args.all:
        for arch in ARCH_IDS:
            for cell in cells_for(arch):
                jobs.append((arch, cell, False))
                jobs.append((arch, cell, True))
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for mp in meshes:
            jobs.append((args.arch, args.cell, mp))

    failures = 0
    for arch, cell, mp in jobs:
        tag = f"{arch}__{cell}__{'pod2' if mp else 'pod1'}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            print(f"[skip] {tag}", flush=True)
            continue
        print(f"[run ] {tag}", flush=True)
        try:
            rec = run_cell(arch, cell, mp, ce_chunk=args.ce_chunk,
                           microbatches=microbatches)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec["roofline"]
            print(f"[ ok ] {tag}: count={rec['count_s']}s "
                  f"bound={r['bound']} compute={r['compute_s']:.4f}s "
                  f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s",
                  flush=True)
        except Exception as e:  # noqa: BLE001
            failures += 1
            with open(out_path + ".err", "w") as f:
                traceback.print_exc(file=f)
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
