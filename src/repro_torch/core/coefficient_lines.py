"""Coefficient lines and line covers (paper §3.2, §3.5, §4.1).

A *coefficient line* is a 1-D slice of the scatter-mode coefficient tensor
``Cs`` along one axis, with all other indices fixed.  Executing one line for
an ``n``-row output block costs ``2r + n`` outer products (Eq. 12 inner sum);
choosing which lines cover the non-zero taps is the central algorithmic
degree of freedom (Table 1 / Table 2).

Covers provided:
  * ``parallel``   — all lines along one axis (the paper's default; every
    input access contiguous).
  * ``orthogonal`` — one central line per axis (star stencils; fewest lines).
  * ``hybrid``     — 3-D star compromise (Table 2, last row).
  * ``minimal``    — minimum axis-parallel line cover via König's theorem
    (bipartite min vertex cover), §3.5.  2-D only, like the paper.  The
    matching is computed here (no graph library), so the port needs
    nothing beyond numpy on the GPU host.
  * ``diagonal``   — main/anti-diagonal lines for Eq. 15-style stencils.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.stencil_spec import StencilSpec

__all__ = [
    "CoefficientLine",
    "LineCover",
    "extract_line",
    "parallel_cover",
    "orthogonal_cover",
    "hybrid_cover",
    "minimal_cover_2d",
    "diagonal_cover",
    "COVER_OPTIONS",
    "make_cover",
    "cover_outer_product_count",
    "vectorized_instruction_count",
]


@dataclasses.dataclass(frozen=True)
class CoefficientLine:
    """One coefficient line of ``Cs``.

    Attributes:
      axis: the *free* axis the line runs along (scatter axis). For a
        diagonal line, ``axis`` is a tuple of (axis, direction) pairs.
      fixed: mapping of the other axes to their fixed offsets in [0, 2r].
      coeffs: the (2r+1,) slice of Cs along ``axis`` at ``fixed``.
    """

    axis: int | tuple[tuple[int, int], ...]
    fixed: tuple[tuple[int, int], ...]  # ((axis, index), ...) sorted
    coeffs: np.ndarray

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.coeffs))

    @property
    def is_diagonal(self) -> bool:
        return isinstance(self.axis, tuple)

    def describe(self) -> str:
        if self.is_diagonal:
            dirs = ",".join(f"{a}:{d:+d}" for a, d in self.axis)
            return f"CLS(diag[{dirs}])"
        parts = ["*" if ax == self.axis else str(dict(self.fixed)[ax])
                 for ax in range(len(self.fixed) + 1)]
        return f"CLS({','.join(parts)})"


@dataclasses.dataclass(frozen=True)
class LineCover:
    """A set of coefficient lines whose union covers all non-zero taps."""

    name: str
    lines: tuple[CoefficientLine, ...]
    spec: StencilSpec

    def validate(self) -> None:
        """Every non-zero tap of Cs must be claimed by exactly one line."""
        cs = self.spec.scatter_coeffs
        claimed = np.zeros_like(cs)
        for line in self.lines:
            for o, c in enumerate(line.coeffs):
                if c == 0.0:
                    continue
                idx = _line_index(line, o, self.spec)
                claimed[idx] += c
        if not np.allclose(claimed, cs):
            raise ValueError(
                f"cover '{self.name}' does not reproduce Cs "
                f"(max err {np.abs(claimed - cs).max():.3g})"
            )


def _line_index(line: CoefficientLine, o: int, spec: StencilSpec) -> tuple[int, ...]:
    ext = spec.extent
    if line.is_diagonal:
        idx = [0] * spec.ndim
        for a, d in line.axis:
            idx[a] = o if d > 0 else ext - 1 - o
        for a, v in line.fixed:
            idx[a] = v
        return tuple(idx)
    idx = [0] * spec.ndim
    idx[line.axis] = o
    for a, v in line.fixed:
        idx[a] = v
    return tuple(idx)


def extract_line(spec: StencilSpec, axis: int, fixed: dict[int, int],
                 mask: np.ndarray | None = None) -> CoefficientLine:
    """Slice Cs along ``axis`` with the other axes fixed.

    ``mask`` optionally zeroes entries already claimed by another line
    (needed when covers share the tap at a line crossing, e.g. the star
    centre — the paper assigns it to exactly one line).
    """
    cs = spec.scatter_coeffs
    if mask is not None:
        cs = cs * mask
    index = [slice(None)] * spec.ndim
    for a, v in fixed.items():
        index[a] = v
    coeffs = np.asarray(cs[tuple(index)])
    return CoefficientLine(
        axis=axis,
        fixed=tuple(sorted(fixed.items())),
        coeffs=coeffs,
    )


def parallel_cover(spec: StencilSpec, axis: int = 0) -> LineCover:
    """All (2r+1)^(d-1) lines along ``axis`` (zero-only lines dropped).

    For 2-D this is the paper's 'parallel' option: lines CLS(*, j),
    j = 0..2r (Table 1 row 1); for 3-D box it is CLS(i, *, k) over all
    (i, k) — the Table 2 'parallel' row keeps only lines with a non-zero.
    """
    ext = spec.extent
    other = [a for a in range(spec.ndim) if a != axis]
    lines = []
    for fixed_vals in itertools.product(range(ext), repeat=len(other)):
        fixed = dict(zip(other, fixed_vals))
        line = extract_line(spec, axis, fixed)
        if line.nnz:
            lines.append(line)
    return LineCover(name=f"parallel[axis={axis}]", lines=tuple(lines), spec=spec)


def orthogonal_cover(spec: StencilSpec) -> LineCover:
    """One central line per axis (star stencils; Table 1/2 'orthogonal').

    The centre tap is claimed by axis 0's line only; subsequent axes mask
    it out to avoid double counting.
    """
    r = spec.order
    lines = []
    mask = np.ones_like(spec.scatter_coeffs)
    for axis in range(spec.ndim):
        fixed = {a: r for a in range(spec.ndim) if a != axis}
        line = extract_line(spec, axis, fixed, mask=mask)
        if line.nnz:
            lines.append(line)
        # claim this line's taps
        for o, c in enumerate(line.coeffs):
            if c != 0.0:
                idx = _line_index(line, o, spec)
                mask[idx] = 0.0
    return LineCover(name="orthogonal", lines=tuple(lines), spec=spec)


def hybrid_cover(spec: StencilSpec) -> LineCover:
    """3-D star hybrid (Table 2 last row): CLS(i,*,r) for i=0..2r plus
    CLS(r,r,*) — all output blocks share one shape ``B[1,n,n]``; only one
    line needs transposed input.
    """
    if spec.ndim != 3:
        raise ValueError("hybrid cover is defined for 3-D stencils")
    r = spec.order
    ext = spec.extent
    mask = np.ones_like(spec.scatter_coeffs)
    lines = []
    for i in range(ext):
        line = extract_line(spec, 1, {0: i, 2: r}, mask=mask)
        if line.nnz:
            lines.append(line)
            for o, c in enumerate(line.coeffs):
                if c != 0.0:
                    mask[_line_index(line, o, spec)] = 0.0
    line = extract_line(spec, 2, {0: r, 1: r}, mask=mask)
    if line.nnz:
        lines.append(line)
    return LineCover(name="hybrid", lines=tuple(lines), spec=spec)


def diagonal_cover(spec: StencilSpec) -> LineCover:
    """Main + anti-diagonal lines (Eq. 15/16). 2-D only."""
    if spec.ndim != 2:
        raise ValueError("diagonal cover is 2-D only")
    cs = spec.scatter_coeffs
    ext = spec.extent
    mask = np.ones_like(cs)
    lines = []
    # main diagonal: offsets (o, o)
    main = np.array([cs[o, o] for o in range(ext)])
    if np.count_nonzero(main):
        lines.append(CoefficientLine(axis=((0, 1), (1, 1)), fixed=(), coeffs=main))
        for o in range(ext):
            mask[o, o] = 0.0
    anti = np.array([(cs * mask)[o, ext - 1 - o] for o in range(ext)])
    if np.count_nonzero(anti):
        lines.append(CoefficientLine(axis=((0, 1), (1, -1)), fixed=(), coeffs=anti))
    cover = LineCover(name="diagonal", lines=tuple(lines), spec=spec)
    return cover


def _max_matching(adj: dict[int, list[int]]) -> dict[int, int]:
    """Maximum bipartite matching (Kuhn's augmenting paths) of a row ->
    columns adjacency; returns ``{column: row}``.  The tap graphs have at
    most ``2r+1`` vertices a side, so the simple search is enough."""
    match: dict[int, int] = {}

    def augment(u: int, seen: set[int]) -> bool:
        for v in adj[u]:
            if v in seen:
                continue
            seen.add(v)
            if v not in match or augment(match[v], seen):
                match[v] = u
                return True
        return False

    for u in adj:
        augment(u, set())
    return match


def _konig_cover(adj: dict[int, list[int]]) -> tuple[set[int], set[int]]:
    """Minimum vertex cover (rows, columns) from a maximum matching by
    König's construction: Z is everything reachable from the unmatched
    rows along alternating paths; the cover is (rows - Z) | (columns & Z).
    """
    col_to_row = _max_matching(adj)
    row_to_col = {u: v for v, u in col_to_row.items()}
    z_rows = {u for u in adj if u not in row_to_col}
    z_cols: set[int] = set()
    stack = list(z_rows)
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v in z_cols or row_to_col.get(u) == v:
                continue
            z_cols.add(v)
            w = col_to_row.get(v)
            if w is not None and w not in z_rows:
                z_rows.add(w)
                stack.append(w)
    return set(adj) - z_rows, z_cols


def minimal_cover_2d(spec: StencilSpec) -> LineCover:
    """Minimum axis-parallel line cover via König's theorem (§3.5).

    The tap matrix is read as the bipartite adjacency between row-vertices
    u_i and column-vertices v_j; a minimum vertex cover (|VC| = max matching,
    König) picks which rows/columns become horizontal/vertical lines.
    Lines are emitted rows first, then columns, each in the name order
    (``"u10" < "u2"``) of the JAX package's cover, so both packages list
    the same lines in the same order.
    """
    if spec.ndim != 2:
        raise ValueError("minimal cover is 2-D only (as in the paper)")
    cs = spec.scatter_coeffs
    ext = spec.extent
    adj = {i: [j for j in range(ext) if cs[i, j] != 0.0] for i in range(ext)}
    adj = {i: js for i, js in adj.items() if js}
    if not adj:
        return LineCover(name="minimal", lines=(), spec=spec)
    cover_rows, cover_cols = _konig_cover(adj)
    mask = np.ones_like(cs)
    lines = []
    # horizontal lines (fixed row i, free axis 1) for u_i in VC
    for i in sorted(cover_rows, key=str):
        line = extract_line(spec, 1, {0: i}, mask=mask)
        if line.nnz:
            lines.append(line)
            for o, c in enumerate(line.coeffs):
                if c != 0.0:
                    mask[i, o] = 0.0
    for j in sorted(cover_cols, key=str):
        line = extract_line(spec, 0, {1: j}, mask=mask)
        if line.nnz:
            lines.append(line)
            for o, c in enumerate(line.coeffs):
                if c != 0.0:
                    mask[o, j] = 0.0
    return LineCover(name="minimal", lines=tuple(lines), spec=spec)


_COVERS = {
    "parallel": lambda s: parallel_cover(s, axis=0),
    "orthogonal": orthogonal_cover,
    "hybrid": hybrid_cover,
    "minimal": minimal_cover_2d,
    "diagonal": diagonal_cover,
}

#: Every cover option name — the planner's search space along the cover
#: axis (``engine.legal_covers`` narrows it per spec shape/ndim).
COVER_OPTIONS = tuple(sorted(_COVERS))


def make_cover(spec: StencilSpec, option: str) -> LineCover:
    if option not in _COVERS:
        raise KeyError(f"unknown cover option {option!r}; choose from {list(COVER_OPTIONS)}")
    cover = _COVERS[option](spec)
    cover.validate()
    return cover


# ---------------------------------------------------------------------------
# §3.4 / Table 1 / Table 2 analysis
# ---------------------------------------------------------------------------

def cover_outer_product_count(cover: LineCover, n: int) -> int:
    """Outer products to update one n-row output block (Eq. 12 inner sums).

    A line with a single non-zero tap degrades to ``n`` scalar-vector
    products (§3.3); a line with >1 non-zero costs ``2r + n`` outer
    products.  Reproduces Table 1: parallel 2-D star = (2r+n) + 2r·n,
    orthogonal 2-D star = 2(2r+n); Table 2: 3-D parallel (2r+n)+4r·n,
    orthogonal 3(2r+n), hybrid 2(2r+n)+2r·n.
    """
    r = cover.spec.order
    total = 0
    for line in cover.lines:
        if line.nnz <= 1:
            total += n
        else:
            total += 2 * r + n
    return total


def vectorized_instruction_count(spec: StencilSpec, n: int) -> int:
    """FMA instruction count per n output vectors for plain vectorization.

    One FMA per non-zero tap per output vector (§3.4): ``taps * n / n`` per
    vector, i.e. ``taps`` per output vector → ``taps * n`` for the block
    rows processed here, normalized to match cover_outer_product_count's
    unit (instructions touching n rows of one n-vector-wide block).
    """
    return spec.taps * n
