"""The benchmark's run: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<mix>.json``: the mix's parameters; its ``"kind"`` names the
  driver, ``drivers/<kind>.py``;
* ``metrics/<metric>.py``: the metric's reader; a name with a dotted
  suffix (``device_idle_pct.serve``) falls back to the reader of the name
  without it (``metrics/device_idle_pct.py``);
* ``limits/<cell>.json``: each number the comparison holds, with its
  limit and the readings the limit was set from;
* ``specs/<spec>.py``: the port's operator built from the configuration
  (its ``"spec"`` key);
* ``reference/<name>.py``: the plain reference a configuration names (its
  ``"reference"`` key); its ``checks`` is the comparison, over the
  answers the driver kept, whatever their form;
* ``kernels/*.json``: the device symbols and launch counters of the
  program's kernels.

The harness itself knows no configuration, mix or comparison: it only
holds what ``checks`` returns to the cell's limits.

The run prints each number compared beside its limit as its last lines on
standard error, and one JSON object as the last line of standard output.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["RunRecord", "Cell", "load_cell", "run_cell", "main"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """A workload entry of BENCHMARK.json with the files it names."""

    name: str
    entry: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    kernels: dict


@dataclasses.dataclass
class RunRecord:
    """What one run measured; the metric readers read it."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0            # host clock, the measured window
    calls: int = 0                   # closed loop: calls in the window
    updates: float = 0.0             # closed loop: grid-point updates
    attempted: int = 0
    failed: int = 0
    bound_s: float | None = None     # least time of one call on the card
    trace: object | None = None      # timeline.DeviceTrace, sub-window
    sub: dict = dataclasses.field(default_factory=dict)  # its counts
    info: dict = dataclasses.field(default_factory=dict)


def _json(path: Path):
    return json.loads(path.read_text())


def load_kernels(directory: Path = HERE / "kernels") -> dict:
    """The union of every kernel list: device symbols and counters."""
    symbols, counters = [], []
    for p in sorted(directory.glob("*.json")):
        d = _json(p)
        symbols += d.get("symbols", [])
        counters += d.get("counters", [])
    return {"symbols": symbols, "counters": counters}


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench_path`` with its configuration, mix,
    limits and metrics; ``overrides`` (``{"config": {...}, "mix":
    {...}}``) replace keys of the files, for tests at small sizes."""
    bench = _json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(ROOT / cfg["file"])
    mix = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    mix.update(overrides.get("mix", {}))
    return Cell(name=name, entry=entry, config=config, mix=mix,
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                kernels=load_kernels())


def _applies(metric: dict, cell: Cell, e2e_names: dict) -> bool:
    if "workloads" in metric:
        return cell.name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    return _applies(e2e_names[moves], cell, e2e_names)


def reader_path(name: str, directory: Path = HERE / "metrics") -> Path:
    """``metrics/<name>.py``, or for a name with a dotted suffix that has
    no file of its own, the reader of the name without the suffix."""
    path = directory / f"{name}.py"
    if not path.is_file() and "." in name:
        path = directory / f"{name.rsplit('.', 1)[0]}.py"
    return path


def read_metrics(record: RunRecord, metrics: list) -> dict:
    """Each metric of ``metrics`` that applies to the cell, read by its
    own reader; a reader that finds nothing leaves its metric out."""
    cell = record.cell
    e2e = {m["name"]: m for m in cell.end_to_end}
    out = {}
    for m in metrics:
        if not _applies(m, cell, e2e):
            continue
        path = reader_path(m["name"])
        spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver_for(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.mix['kind']}")


def reference_for(cell: Cell):
    """The plain reference module the cell's configuration names."""
    return importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")


def compare(cell: Cell, answers: list, control: str | None,
            device) -> tuple:
    """``(checks, info)``: the numbers the reference's ``checks`` compares
    over the kept answers (with ``control``, its lower precision in the
    program's place), and what it records beside them."""
    return reference_for(cell).checks(cell.config, answers, control, device)


def _card(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return {"platform": "gpu", "kind": name, "power_limit": out}


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device, t0: float, control: str | None = None,
             parts: dict | None = None) -> dict:
    """Set up, warm, measure, compare; returns the result object.
    ``parts`` are set-up times taken before, for the record: ``at_*``
    seconds from the process's start, the others each step's length."""
    import torch
    parts = dict(parts or {}, at_start_s=time.perf_counter() - t0)
    drv = driver_for(cell)
    t = time.perf_counter()
    system = drv.System(cell, device)
    parts["system_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.inputs(seed)
    if trace:
        from portbench.drivers.common import prime_profiler
        prime_profiler(device)
    parts["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    system.warm()
    parts["warm_s"] = time.perf_counter() - t
    for line in system.describe():
        log(line)
    record = RunRecord(cell=cell)
    record.info.update(parts)
    system.window(record, seconds, trace, seed, t0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    answers = system.answers()
    system.release()
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, info = compare(cell, answers, control, device)
    del answers
    record.info.update(info)
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    correct = (record.attempted > 0 and record.failed == 0
               and all(checks[k] <= limits[k] for k in limits))
    card = _card(device)
    result = {
        "correct": bool(correct),
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": read_metrics(record, cell.per_layer if trace
                                else cell.end_to_end),
        "device": {"platform": card["platform"], "kind": card["kind"],
                   "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": int(peak)},
    }
    if trace:
        t = record.trace
        result["device"]["busy_s"] = t.busy_s if t else 0.0
        result["device"]["window_s"] = t.window_s if t else 0.0
        if t is not None:
            result["breakdown"] = {"device_ops": t.ops, "idle_gaps": t.gaps}
    result["card"] = {"power_limit": card["power_limit"]}
    result["info"] = {k: _number(v) for k, v in record.info.items()}
    if control:
        result["control"] = control
    result["checks"] = {k: {"value": _number(checks[k]), "limit": limits[k]}
                        for k in limits}
    log(f"card: {card['kind']}; nvidia-smi name, power.limit: "
        f"{card['power_limit']}")
    log("info: " + json.dumps(result["info"]))
    log(f"attempted {record.attempted}, failed {record.failed} (limit 0)")
    for k in limits:
        log(f"check {k}: {checks[k]!r} (limit {limits[k]!r})")
    return result


def loaded_forbidden() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv: list[str], t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="compare the reference in this lower precision "
                         "in the program's place, one of the reference's "
                         "CONTROLS (must come out not correct)")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    parts = {"at_args_s": time.perf_counter() - t0}
    if args.control not in (None,) + tuple(reference_for(cell).CONTROLS):
        ap.error(f"--control {args.control!r}: the reference of "
                 f"{cell.name} has {reference_for(cell).CONTROLS}")
    import torch
    parts["at_torch_s"] = time.perf_counter() - t0
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no result: the cell needs {need} CUDA device(s); "
            f"cuda available {torch.cuda.is_available()}, devices "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    parts["at_port_s"] = time.perf_counter() - t0
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        log(f"no result: repro_torch loaded from {where}, not from this "
            f"checkout's src/")
        return 4
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device=torch.device("cuda", 0), t0=t0,
                      control=args.control, parts=parts)
    bad = loaded_forbidden()
    if bad:
        log(f"no result: modules {bad} are loaded in the process that "
            f"prints the result")
        return 5
    print(json.dumps(result), flush=True)
    return 0
