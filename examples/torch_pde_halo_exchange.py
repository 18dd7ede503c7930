"""Distributed 2-D heat equation through the unified plan/compile API.

The problem declares the mesh; the planner picks cover x backend x fuse
depth by roofline model and records every decision; compile() emits the
fused sharded stepper — ONE ``T*r``-deep halo exchange per fused chunk
(counted below by the exchange census), each slot's block stepped by the
step or sweep kernel.

    PYTHONPATH=src python examples/torch_pde_halo_exchange.py \\
        [--mesh 2x2] [--device cpu]

One process drives every slot of the mesh; on the card every slot is the
one card (``cuda:0``), as four fake devices stand in for a 2x2 mesh in
the JAX reference's tests.  It runs on the card unless ``--device cpu``
is given.
"""
import argparse

import torch

from repro_torch import api
from repro_torch.core import distributed as dist
from repro_torch.core.engine import StencilEngine, resolve_device
from repro_torch.launch.mesh import make_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x2", help="gx x gy slots")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gx, gy = (int(n) for n in args.mesh.split("x"))
    mesh = make_mesh((gx, gy), ("gx", "gy"), devices=device)
    print(f"slots={mesh.size} mesh=({gx},{gy}) on {device}")

    # 2D9P heat-like stencil (normalized coefficients -> diffusion)
    spec = api.box(2, 1, seed=0)
    steps = 50
    problem = api.StencilProblem(spec, grid=(256, 256), boundary="periodic",
                                 steps=steps, mesh=mesh,
                                 grid_axes=("gx", "gy"))
    plan = api.plan(problem, backends=["cuda"], max_depth=5)
    print(plan.explain())

    step = api.compile(plan, mesh=mesh, device=device)
    field = torch.zeros((256, 256), dtype=torch.float32, device=device)
    field[128, 128] = 1000.0
    dist.reset_exchange_counts()
    out = step(field)
    census = dict(dist.exchange_counts)
    print(f"after {steps} steps (schedule {plan.fuse_schedule}): "
          f"mass={float(out.sum()):9.3f} peak={float(out.max()):.5f}")

    # verify against the single-device engine
    eng = StencilEngine(spec, boundary="periodic", device=device)
    ref = field
    for _ in range(steps):
        ref = eng(ref)
    err = float(torch.abs(out - ref).max())
    print(f"max |distributed fused - single-device sequential|: {err:.2e}")
    assert err < 1e-4

    # the collective schedule proof: one T*r-deep exchange per fused chunk
    # and named mesh axis, each exchange a permute in either direction
    n_chunks = len(plan.fuse_schedule)
    print(f"exchange permutes: {census['permutes']} "
          f"(= {n_chunks} chunks x 2 mesh axes x 2 directions)")
    assert census["permutes"] == n_chunks * 2 * 2
    # The reference also counts collective-permutes in the compiled HLO;
    # the port compiles no HLO, so the census above is the whole proof.

    # the modelled story the planner told
    ch = plan.chosen()
    print(f"chosen depth={plan.fuse_depth} cover={plan.option} "
          f"backend={plan.backend}: modelled "
          f"{ch.t_per_step * 1e9:.1f} ns/step on {plan.hw['name']}, "
          f"halo traffic {ch.ici_bytes / 1e3:.1f} kB/chunk over NVLink")
    return {"err": err, "census": census, "chunks": n_chunks,
            "mass": float(out.sum()), "plans": [plan], "mesh": mesh}


if __name__ == "__main__":
    main()
