"""Quickstart: stencil matrixization in five minutes, on the H100.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the card unless ``--device cpu`` is given; there the ``cuda``
backend's kernel wrappers use their plain PyTorch versions.
"""
import argparse

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.codegen import generate_update
from repro_torch.core.coefficient_lines import make_cover
from repro_torch.core.engine import resolve_device
from repro_torch.core.matrixization import matrixized_apply
from repro_torch.kernels.ref import stencil_ref


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. define a stencil (2D9P box, order 1) and inspect its duality
    spec = api.box(2, 1, seed=0)
    print("gather coefficients:\n", np.asarray(spec.gather_coeffs).round(3))
    print("scatter coefficients (Eq.5 C^s = J C^g J):\n",
          np.asarray(spec.scatter_coeffs).round(3))

    # 2. pick a coefficient-line cover and evaluate via banded-Toeplitz
    #    products (tensor-core-shaped matmuls)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(130, 130)),
                        dtype=torch.float32).to(device)
    cover = make_cover(spec, "parallel")
    y = matrixized_apply(x, spec, cover)
    err = float(torch.abs(y - stencil_ref(x, spec)).max())
    print(f"\nmatrixized vs gather oracle: max err {err:.2e}")
    assert err <= 1e-4

    # 3. the unified API: declare the problem, plan it, inspect EVERY
    #    decision with its modelled roofline cost, then compile
    problem = api.StencilProblem(api.star(2, 3, seed=1), grid=(128, 128),
                                 boundary="periodic", steps=32)
    p = api.plan(problem)          # frozen + JSON-serializable
    print("\n" + p.explain())
    assert api.ExecutionPlan.from_json(p.to_json()) == p  # ships as JSON

    # 4. the code generator (paper §4.4) emits the unrolled update for the
    #    planned engine (the engine is a thin wrapper over the same plan)
    eng = api.StencilEngine.from_execution_plan(p, device=device)
    gen = generate_update(eng.plan)
    print("\ngenerated kernel (head):")
    print("\n".join(gen.source.splitlines()[:8]))

    # 5. evolve a heat-like field: compile(plan) runs the fused schedule
    #    through the step and sweep kernels on the card
    field = torch.zeros((64, 64), device=device)
    field[32, 32] = 100.0
    prob2 = api.StencilProblem(api.box(2, 1, seed=3), grid=(64, 64),
                               boundary="periodic", steps=100)
    run = api.compile(api.plan(prob2, backends=["cuda"]), device=device)
    out = run(field)
    _sync(device)
    mass, mass0 = float(out.sum()), float(field.sum())
    print(f"\nafter 100 steps (fuse schedule "
          f"{run.plan.schedule_str()}): "
          f"total mass {mass:.3f} "
          f"(conserved from {mass0:.3f}), "
          f"peak {float(out.max()):.4f}")
    return {"oracle_err": err, "mass": mass, "mass0": mass0,
            "peak": float(out.max()), "plans": [run.plan]}


if __name__ == "__main__":
    main()
