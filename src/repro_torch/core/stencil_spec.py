"""Stencil specifications: taps, gather/scatter duality (paper Eq. 1-6).

A stencil is a constant-coefficient neighbourhood update on a structured
grid.  The *gather* view (Eq. 1) computes one output from its neighbours;
the *scatter* view (Eq. 3) fans one input out to its neighbours.  The two
coefficient tensors are related by full index reversal, ``Cs = J Cg J``
(Eq. 5) — in d dimensions, reversing every axis.

Conventions (paper footnote 1): C-style storage; for 2-D stencils the index
is (i, j) with j contiguous; for 3-D it is (i, j, k) with k contiguous.

Beyond the constant-coefficient core, a spec may carry two per-point
scenario fields (DESIGN.md §Scenarios):

* ``coefficients="varying"`` with a ``coeff_field`` — a scalar field
  ``a`` on the problem grid scaling each output point:
  ``y[p] = a[p] * (L x)[p]``.  Per axis the banded Toeplitz operand
  becomes the banded matrix ``diag(a_line) @ T`` (the ``spdiags`` shape),
  executed as the shared Toeplitz contraction followed by an elementwise
  f32 row scale so the one-``dot_general``-per-axis structure survives.
* ``domain_mask`` — a boolean indicator of the active domain; each step
  projects its output onto the mask (``y = M * (a * (L x))``), which is
  the obstacle / land-sea masking workload.

Both fields are spatial (no batch axis), align CENTERED against any
valid-mode output (offset ``(field_extent - out_extent) // 2`` per axis),
and are content-addressed (:meth:`StencilSpec.scenario_digest`) for plan
and cache identity.

This module is numpy only: the PyTorch port keeps its own copy of the
JAX package's spec layer (same seeds, same numbers), and
:func:`from_numpy` rebuilds a spec from the JAX package's numpy-level
description so a problem can be carried across unchanged.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Mapping, Sequence

import numpy as np

__all__ = [
    "StencilSpec",
    "box",
    "star",
    "diagonal",
    "from_gather_coeffs",
    "from_numpy",
    "random_coeff_field",
    "random_domain_mask",
    "PAPER_SUITE",
]


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A constant-coefficient stencil.

    Attributes:
      ndim: spatial dimensionality (2 or 3 — the paper's suite and the
        dimensionalities the Hopper kernels take).
      order: radius r; the tap tensor has extent 2r+1 per axis.
      gather_coeffs: the gather-mode coefficient tensor ``Cg`` of shape
        (2r+1,)*ndim.  Entry ``Cg[o]`` multiplies input at offset
        ``o - r`` relative to the output point (Eq. 1/2).
      shape: descriptive tag ("box" | "star" | "diagonal" | "general").
      coefficients: "constant" (the paper's case — one shared tap tensor)
        or "varying" (a per-point scalar field scales the update).
      coeff_field: the scalar coefficient field ``a`` on the problem grid
        (required iff ``coefficients="varying"``; float64, spatial only).
      domain_mask: optional boolean active-domain indicator on the problem
        grid; every step's output is projected onto it.
    """

    ndim: int
    order: int
    gather_coeffs: np.ndarray
    shape: str = "general"
    coefficients: str = "constant"
    coeff_field: np.ndarray | None = None
    domain_mask: np.ndarray | None = None

    def __post_init__(self):
        c = np.asarray(self.gather_coeffs, dtype=np.float64)
        object.__setattr__(self, "gather_coeffs", c)
        expect = (2 * self.order + 1,) * self.ndim
        if c.shape != expect:
            raise ValueError(
                f"gather_coeffs shape {c.shape} != {expect} for ndim="
                f"{self.ndim}, order={self.order}"
            )
        if self.coefficients not in ("constant", "varying"):
            raise ValueError(
                f"coefficients must be 'constant' or 'varying', got "
                f"{self.coefficients!r}")
        if self.coefficients == "varying":
            if self.coeff_field is None:
                raise ValueError("coefficients='varying' requires coeff_field")
            f = np.asarray(self.coeff_field, dtype=np.float64)
            if f.ndim != self.ndim:
                raise ValueError(
                    f"coeff_field ndim {f.ndim} != spec ndim {self.ndim}")
            object.__setattr__(self, "coeff_field", f)
        elif self.coeff_field is not None:
            raise ValueError("coeff_field given but coefficients='constant'")
        if self.domain_mask is not None:
            m = np.asarray(self.domain_mask).astype(bool)
            if m.ndim != self.ndim:
                raise ValueError(
                    f"domain_mask ndim {m.ndim} != spec ndim {self.ndim}")
            if self.coeff_field is not None and m.shape != self.coeff_field.shape:
                raise ValueError(
                    f"domain_mask shape {m.shape} != coeff_field shape "
                    f"{self.coeff_field.shape}")
            object.__setattr__(self, "domain_mask", m)

    # -- scatter duality (Eq. 5): Cs = J Cg J = reverse every axis ---------
    @property
    def scatter_coeffs(self) -> np.ndarray:
        return self.gather_coeffs[(slice(None, None, -1),) * self.ndim]

    @property
    def taps(self) -> int:
        """Number of non-zero coefficients."""
        return int(np.count_nonzero(self.gather_coeffs))

    @property
    def extent(self) -> int:
        return 2 * self.order + 1

    def offsets(self) -> list[tuple[int, ...]]:
        """Non-zero tap offsets in gather view (relative to the output)."""
        idx = np.argwhere(self.gather_coeffs != 0.0)
        return [tuple(int(x) - self.order for x in row) for row in idx]

    def with_coeffs(self, gather_coeffs: np.ndarray) -> "StencilSpec":
        return dataclasses.replace(self, gather_coeffs=np.asarray(gather_coeffs))

    # -- scenario fields (varying coefficients / masked domains) -----------
    @property
    def is_varying(self) -> bool:
        return self.coefficients == "varying"

    @property
    def is_masked(self) -> bool:
        return self.domain_mask is not None

    @property
    def is_constant_dense(self) -> bool:
        """The paper's base case: constant coefficients on a dense box."""
        return not self.is_varying and not self.is_masked

    def with_field(self, coeff_field: np.ndarray,
                   domain_mask: np.ndarray | None = None) -> "StencilSpec":
        """A varying-coefficient copy of this spec (optionally masked)."""
        return dataclasses.replace(
            self, coefficients="varying", coeff_field=np.asarray(coeff_field),
            domain_mask=(self.domain_mask if domain_mask is None
                         else domain_mask))

    def with_mask(self, domain_mask: np.ndarray) -> "StencilSpec":
        """A masked-domain copy of this spec."""
        return dataclasses.replace(self, domain_mask=np.asarray(domain_mask))

    def base(self) -> "StencilSpec":
        """The constant-coefficient unmasked core of this spec."""
        if self.is_constant_dense:
            return self
        return dataclasses.replace(self, coefficients="constant",
                                   coeff_field=None, domain_mask=None)

    def scenario_digest(self) -> str:
        """Content address of the scenario fields ('' for the base case).

        Two specs differing only in coefficient field or mask must be
        distinct plan-cache identities; the digest covers kind, bytes and
        shape of both fields.
        """
        if self.is_constant_dense:
            return ""
        h = hashlib.sha1()
        h.update(self.coefficients.encode())
        if self.coeff_field is not None:
            h.update(str(self.coeff_field.shape).encode())
            h.update(np.ascontiguousarray(self.coeff_field).tobytes())
        h.update(b"|mask|")
        if self.domain_mask is not None:
            h.update(str(self.domain_mask.shape).encode())
            h.update(np.ascontiguousarray(self.domain_mask).tobytes())
        return h.hexdigest()[:16]

    def describe(self) -> str:
        names = {2: "2D", 3: "3D", 1: "1D"}
        tag = f"{names.get(self.ndim, f'{self.ndim}D')}{self.taps}P {self.shape} (r={self.order})"
        extras = []
        if self.is_varying:
            extras.append("varying")
        if self.is_masked:
            extras.append("masked")
        return tag + (f" [{'+'.join(extras)}]" if extras else "")


def _rng_coeffs(shape, mask, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.1, 1.0, size=shape)
    c *= mask
    # Normalize so repeated application stays bounded (heat-equation-like).
    c /= c.sum()
    return c


def box(ndim: int, order: int, coeffs: np.ndarray | None = None, seed: int = 0) -> StencilSpec:
    """Dense (2r+1)^d box stencil — e.g. 2D9P (ndim=2, r=1), 3D27P."""
    ext = 2 * order + 1
    shape = (ext,) * ndim
    if coeffs is None:
        coeffs = _rng_coeffs(shape, np.ones(shape), seed)
    return StencilSpec(ndim=ndim, order=order, gather_coeffs=coeffs, shape="box")


def star(ndim: int, order: int, coeffs: np.ndarray | None = None, seed: int = 0) -> StencilSpec:
    """Axis-aligned star stencil — e.g. 2D5P (ndim=2, r=1), 3D7P.

    Non-zeros only where all-but-one index equals r (Eq. 13).
    """
    ext = 2 * order + 1
    shape = (ext,) * ndim
    mask = np.zeros(shape)
    center = (order,) * ndim
    mask[center] = 1.0
    for ax in range(ndim):
        for o in range(ext):
            idx = list(center)
            idx[ax] = o
            mask[tuple(idx)] = 1.0
    if coeffs is None:
        coeffs = _rng_coeffs(shape, mask, seed)
    else:
        coeffs = np.asarray(coeffs) * mask
    return StencilSpec(ndim=ndim, order=order, gather_coeffs=coeffs, shape="star")


def diagonal(order: int, coeffs: np.ndarray | None = None, seed: int = 0) -> StencilSpec:
    """2-D stencil with non-zeros on main + anti diagonal only (Eq. 15)."""
    ext = 2 * order + 1
    mask = np.zeros((ext, ext))
    for o in range(ext):
        mask[o, o] = 1.0
        mask[o, ext - 1 - o] = 1.0
    if coeffs is None:
        coeffs = _rng_coeffs((ext, ext), mask, seed)
    else:
        coeffs = np.asarray(coeffs) * mask
    return StencilSpec(ndim=2, order=order, gather_coeffs=coeffs, shape="diagonal")


def random_coeff_field(grid: Sequence[int], seed: int = 0,
                       lo: float = 0.5, hi: float = 1.5) -> np.ndarray:
    """Seeded positive scalar coefficient field on ``grid`` (float64).

    Bounded away from 0 so repeated application stays well-conditioned;
    the shared generator for tests, benchmarks and docs.
    """
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=tuple(grid))


def random_domain_mask(grid: Sequence[int], seed: int = 0,
                       active: float = 0.75) -> np.ndarray:
    """Seeded boolean domain mask on ``grid`` with ~``active`` fraction
    active: a random rectangular obstacle (a contiguous inactive hole)
    plus salt noise — the land/sea-mask shape rather than pure speckle."""
    rng = np.random.default_rng(seed)
    mask = np.ones(tuple(grid), dtype=bool)
    hole = tuple(slice(g // 4, g // 4 + max(1, int(g * (1.0 - active) ** 0.5)))
                 for g in grid)
    mask[hole] = False
    mask &= rng.uniform(size=tuple(grid)) < (active ** 0.25)
    return mask


def from_gather_coeffs(coeffs: np.ndarray, shape: str = "general", *,
                       coefficients: str = "constant",
                       coeff_field: np.ndarray | None = None,
                       domain_mask: np.ndarray | None = None) -> StencilSpec:
    c = np.asarray(coeffs)
    ndim = c.ndim
    if len(set(c.shape)) != 1 or c.shape[0] % 2 != 1:
        raise ValueError(f"coefficient tensor must be odd-cubic, got {c.shape}")
    order = (c.shape[0] - 1) // 2
    return StencilSpec(ndim=ndim, order=order, gather_coeffs=c, shape=shape,
                       coefficients=coefficients, coeff_field=coeff_field,
                       domain_mask=domain_mask)


def from_numpy(desc: Mapping[str, Any]) -> StencilSpec:
    """A spec from a numpy-level description with identical numbers.

    ``desc`` is the ``"spec"`` entry of a serialized problem
    (``StencilProblem.to_dict()`` of either package): ``gather_coeffs``,
    ``shape``, ``coefficients`` and the optional ``coeff_field`` /
    ``domain_mask``, as lists or arrays.
    """
    field = desc.get("coeff_field")
    mask = desc.get("domain_mask")
    return from_gather_coeffs(
        np.asarray(desc["gather_coeffs"], np.float64),
        desc.get("shape", "general"),
        coefficients=desc.get("coefficients", "constant"),
        coeff_field=None if field is None else np.asarray(field, np.float64),
        domain_mask=None if mask is None else np.asarray(mask).astype(bool))


def PAPER_SUITE() -> dict[str, StencilSpec]:
    """The paper's evaluation suite (§5): 2-D/3-D box and star, r = 1..3.

    Orders match Table 3 (3-D box only up to r=2 there; we include r=3 for
    completeness of the sweep).
    """
    suite: dict[str, StencilSpec] = {}
    for r in (1, 2, 3):
        suite[f"box2d_r{r}"] = box(2, r, seed=10 + r)
        suite[f"star2d_r{r}"] = star(2, r, seed=20 + r)
        suite[f"box3d_r{r}"] = box(3, r, seed=30 + r)
        suite[f"star3d_r{r}"] = star(3, r, seed=40 + r)
    suite["diag2d_r1"] = diagonal(1, seed=50)
    return suite
