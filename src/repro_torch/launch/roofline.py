"""Roofline reporting from dry-run records (``launch/dryrun.py``).

Terms per (arch x cell), single-pod mesh, per H100 SXM5 (a mean over
the mesh's slots):
    compute_s    = counted dot FLOPs / 989 TFLOP/s (bf16) or 67 (f32)
    memory_s     = counted traffic bytes / 3.35 TB/s
    collective_s = census wire bytes / 450 GB/s (NVLink, each way)
plus MODEL_FLOPS (6ND / 6N_active·D), the useful-compute ratio, the
dominant term, and a one-line "what would move it" note.
"""
from __future__ import annotations

import glob
import json
import os

__all__ = ["load_records", "rows", "print_table", "markdown_table"]


def load_records(directory: str, mesh: str = "pod1"):
    recs = []
    for f in sorted(glob.glob(os.path.join(directory, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _advice(rec) -> str:
    r = rec["roofline"]
    b = r["bound"]
    kind = rec.get("cell", "")
    if b == "memory_s":
        if "train" in kind or "prefill" in kind:
            return ("fuse attention score streaming (a flash kernel keeps "
                    "scores in shared memory); bf16 intermediates")
        return "shard / shrink KV cache reads; fuse cache update + attention"
    if b == "collective_s":
        return ("reshard to cut all-gathers (keep TP transfers per layer "
                "to 1 gather + 1 reduce-scatter over NVLink); overlap with "
                "compute")
    return ("increase per-card batch or sequence tile to raise tensor-core "
            "occupancy")


def rows(directory: str, mesh: str = "pod1"):
    out = []
    for rec in load_records(directory, mesh):
        r = rec["roofline"]
        dom = {"compute_s": "compute", "memory_s": "memory",
               "collective_s": "collective"}[r["bound"]]
        peak_frac = r["compute_s"] / max(r["compute_s"], r["memory_s"],
                                         r["collective_s"])
        out.append({
            "arch": rec["arch"], "cell": rec["cell"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bound": dom,
            "model_tflops_per_dev": r["model_flops_per_dev"] / 1e12,
            "useful_ratio": r["useful_ratio"],
            "roofline_frac": peak_frac,
            "temp_gb": (rec["memory"]["temp_bytes"] or 0) / 1e9,
            "advice": _advice(rec),
        })
    return out


def print_table(directory: str, mesh: str = "pod1"):
    rs = rows(directory, mesh)
    print("arch,cell,bound,compute_s,memory_s,collective_s,"
          "useful_ratio,roofline_frac,temp_gb")
    for r in rs:
        print(f"{r['arch']},{r['cell']},{r['bound']},{r['compute_s']:.4f},"
              f"{r['memory_s']:.4f},{r['collective_s']:.4f},"
              f"{(r['useful_ratio'] or 0):.3f},{r['roofline_frac']:.3f},"
              f"{r['temp_gb']:.1f}")


def markdown_table(directory: str, mesh: str = "pod1") -> str:
    rs = rows(directory, mesh)
    lines = ["| arch | cell | bound | compute (s) | memory (s) | collective (s) "
             "| useful ratio | roofline frac | temp GB | next lever |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rs:
        lines.append(
            f"| {r['arch']} | {r['cell']} | **{r['bound']}** "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | {(r['useful_ratio'] or 0):.3f} "
            f"| {r['roofline_frac']:.3f} | {r['temp_gb']:.1f} "
            f"| {r['advice']} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    print_table(sys.argv[1] if len(sys.argv) > 1 else "dryrun_results")
