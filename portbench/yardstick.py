"""The benchmark's arithmetic: work counted from the problem's shapes,
the card's peaks, percentiles and the comparison that decides
``correct``.  Nothing here reads the program: the counts follow the
problem, so they read the same whatever implements the work.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent

__all__ = ["stencil_call_work", "card_peaks", "bound_s", "percentile",
           "max_rel_err"]


def stencil_call_work(grid, n_taps: int, steps: int,
                      itemsize: int = 4) -> tuple[float, float]:
    """(bytes, flops) one call of ``steps`` stencil steps needs: the state
    read once and written once; one multiply and one add a tap, point and
    step."""
    points = math.prod(int(g) for g in grid)
    return 2.0 * points * itemsize, 2.0 * n_taps * points * steps


def card_peaks(device_name: str, table: Path = HERE / "peaks.json"):
    """The peaks entry whose key is a substring of ``device_name``, or
    None for a card the table does not know."""
    cards = json.loads(table.read_text())["cards"]
    for key, peaks in cards.items():
        if key in device_name:
            return peaks
    return None


def bound_s(nbytes: float, flops: float, peaks) -> float:
    """The least time the card could take: bytes over HBM bandwidth
    against flops over the fastest f32-accurate rate."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_accurate_flops_per_s"])


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: the
    smallest value with at least ``q`` percent of the samples at or below
    it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def max_rel_err(got, want) -> float:
    """max|got - want| / max|want|, in float64 (inf where the shapes
    differ, nan where ``got`` is not finite)."""
    import torch
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    want = want.to(torch.float64)
    diff = (got.to(device=want.device, dtype=torch.float64) - want).abs()
    return float(diff.max() / want.abs().max())
