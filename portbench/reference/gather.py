"""The plain reference of a constant-coefficient stencil on a periodic grid.

Each step is a gather of shifted copies: ``y[p] = sum_o c_o * x[p + o]``
over the configuration's taps ``(o, c_o)``, with ``torch.roll`` wrapping
the periodic boundary.  It takes the configuration's numbers and the
benchmark's inputs, and nothing the program made: no plan, cover, band,
tile or padded buffer.

:func:`evolve` works in float64 (the comparison's reference);
:func:`evolve_tf32` is the same arithmetic one precision below the
configuration's float32, as TF32 tensor cores would do it: every operand
rounded to TF32's 10-bit mantissa, products and sums in float32 (the
control that has to come out as not correct).

:func:`checks` is the comparison the harness holds to the cell's limits:
it takes the configuration and the answers the driver kept, each
``(label, input, output, steps)``, and works every reference out again
from the input.
"""
from __future__ import annotations

import math

import torch

__all__ = ["CONTROLS", "checks", "evolve", "evolve_tf32", "tf32_round"]

#: the lower precisions that can stand in the program's place
CONTROLS = ("tf32",)


def _shifts(offset) -> tuple[int, ...]:
    # torch.roll(x, s)[p] == x[p - s], and the tap reads x[p + o]
    return tuple(-int(o) for o in offset)


def evolve(x: torch.Tensor, taps, steps: int,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``steps`` periodic applications of ``taps`` to ``x`` (any leading
    batch axes; the stencil acts on the last ``len(offset)`` axes), in
    ``dtype``."""
    nd = len(taps[0]) - 1
    dims = tuple(range(-nd, 0))
    x = x.to(dtype)
    for _ in range(steps):
        y = torch.zeros_like(x)
        for *offset, c in taps:
            y.add_(torch.roll(x, _shifts(offset), dims), alpha=float(c))
        x = y
    return x


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 explicit
    mantissa bits; ties to even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def evolve_tf32(x: torch.Tensor, taps, steps: int) -> torch.Tensor:
    """:func:`evolve` as TF32 tensor cores compute it: the state and the
    coefficients rounded to TF32 before each product, float32 sums."""
    nd = len(taps[0]) - 1
    dims = tuple(range(-nd, 0))
    coeffs = tf32_round(torch.tensor([float(t[-1]) for t in taps]))
    x = x.to(torch.float32)
    for _ in range(steps):
        xr = tf32_round(x)
        y = torch.zeros_like(x)
        for (*offset, _), c in zip(taps, coeffs.tolist()):
            y.add_(torch.roll(xr, _shifts(offset), dims), alpha=c)
        x = y
    return x


def checks(config: dict, answers: list, control: str | None,
           device) -> tuple[dict, dict]:
    """``({"max_rel_err": widest gap}, info)`` over ``answers``: the widest
    ``max|answer - reference| / max|reference|``, the reference in float64
    worked out from each answer's input.  With ``control`` (one of
    :data:`CONTROLS`) the reference in that precision stands in the
    program's place.  ``info`` gives, for the record, what an answer left
    unchanged would read."""
    from portbench.yardstick import max_rel_err
    taps = config["taps"]
    worst, unchanged = 0.0, math.inf
    for _label, x, y, steps in answers:
        x = torch.as_tensor(x).to(device)
        want = evolve(x, taps, steps)
        got = evolve_tf32(x, taps, steps) if control == "tf32" else y
        err = max_rel_err(got, want)
        if not math.isnan(worst) and (math.isnan(err) or err > worst):
            worst = err
        unchanged = min(unchanged, max_rel_err(x, want))
        del want, got, x
    return {"max_rel_err": worst}, {"unchanged_state_reads": unchanged}
