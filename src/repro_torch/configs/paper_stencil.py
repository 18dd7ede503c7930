"""The paper's own workload configs (§5): 2-D/3-D box/star stencils,
orders 1-3, in-cache and out-of-cache problem sizes, with the engine
options Table 3 reports as best per case."""
import dataclasses

from repro_torch.core.stencil_spec import PAPER_SUITE, StencilSpec

__all__ = ["StencilCase", "PAPER_CASES"]


@dataclasses.dataclass(frozen=True)
class StencilCase:
    name: str
    spec: StencilSpec
    sizes: tuple           # problem sizes per Table 3
    best_option: str       # coefficient-line option Table 3 selects
    block: tuple


def PAPER_CASES():
    suite = PAPER_SUITE()
    cases = []
    for r in (1, 2, 3):
        cases.append(StencilCase(
            name=f"box2d_r{r}", spec=suite[f"box2d_r{r}"],
            sizes=(64, 128, 256, 512), best_option="parallel",
            block=(128, 128)))
        cases.append(StencilCase(
            name=f"star2d_r{r}", spec=suite[f"star2d_r{r}"],
            sizes=(64, 128, 256, 512),
            best_option="parallel" if r == 1 else "orthogonal",
            block=(128, 128)))
        if r <= 2:
            cases.append(StencilCase(
                name=f"box3d_r{r}", spec=suite[f"box3d_r{r}"],
                sizes=(8, 16, 32, 64), best_option="parallel",
                block=(8, 8, 128)))
        cases.append(StencilCase(
            name=f"star3d_r{r}", spec=suite[f"star3d_r{r}"],
            sizes=(8, 16, 32, 64),
            best_option="parallel" if r == 1 else "orthogonal",
            block=(8, 8, 128)))
    return cases
