"""Assimilation-style rollout: forced prediction windows, observation
nudges, streamed frames, and a kill/resume demonstration, on the H100.

A weather-style loop is not one uninterrupted sweep: every few steps a
forcing term lands, an observation nudges the state toward data, and a
frame streams out for IO.  This example states that loop as a
`RolloutProgram`, plans it per segment (update points are fusion
barriers — `rplan.explain()` prices exactly what the segmentation
costs), runs it with checkpointed fault-tolerant execution, then kills
it mid-program and resumes bit-exactly.

    PYTHONPATH=src python examples/torch_assimilation_rollout.py \\
        [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.engine import resolve_device
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, RestartPolicy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. the program: 3 forced prediction windows with a nudge between
    spec = api.box(2, 1, seed=0)
    problem = api.StencilProblem(spec, grid=(64, 64), boundary="periodic",
                                 steps=1, batch=2)
    program = api.RolloutProgram(problem, [
        api.Segment(8, api.UpdateOp("source", {"scale": 0.05, "seed": 1}),
                    emit=True),
        api.Segment(4, api.UpdateOp("nudge", {"gain": 0.3, "seed": 2})),
        api.Segment(8, api.UpdateOp("source", {"scale": 0.05, "seed": 1}),
                    emit=True),
        api.Segment(12, emit=True)])
    print(f"program: {len(program.segments)} segments, "
          f"{program.total_steps} steps, digest {program.digest()}")

    # 2. plan: per-segment fuse decisions + the fused-vs-stepwise traffic
    rplan = api.plan_program(program, backends=["cuda"])
    print("\n" + rplan.explain())

    # 3. compile + stream: emits land at segment boundaries for free
    run = api.compile_program(rplan, device=device)
    x0 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(problem.batch,) + problem.grid).astype(np.float32)).to(device)
    res = run.run(x0)
    emit_steps = [t for t, _ in res.emits]
    print(f"\nemitted frames at steps {emit_steps}")

    # 4. checkpointed execution, killed mid-program, resumed bit-exactly
    ckdir = tempfile.mkdtemp(prefix="rollout_ck_")
    armed = {"on": True}

    def kill_once(segment, attempt):
        if segment == 2 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected preemption")

    try:
        api.run_checkpointed(run, x0, directory=ckdir,
                             fault_injector=kill_once)
    except RuntimeError as e:
        print(f"\nkilled mid-program: {e}")
    resumed = api.run_checkpointed(
        run, x0, directory=ckdir,
        monitor=HeartbeatMonitor(hard_timeout_s=600.0),
        restart=RestartPolicy(max_failures=2, backoff_s=0.0))
    exact = torch.equal(resumed.final, res.final)
    print(f"resumed from latest segment checkpoint: bit-exact={exact}")
    assert exact

    # 5. the same program through the serving loop, batched per segment
    server = api.StencilServer(spec, steps=1, max_batch=4,
                               backends=["cuda"], devices=[device])
    states = [np.random.default_rng(i).normal(size=(64, 64))
              .astype(np.float32) for i in range(3)]
    tickets = [server.submit_rollout(s, program.segments) for s in states]
    server.flush()
    final_steps = []
    for t in tickets:
        frames = server.rollout_results(t)
        assert server.rollout_done(t)
        final_steps.append(frames[-1][0])
        print(f"ticket {t}: {len(frames)} frames, final step "
              f"{frames[-1][0]}")
    batches = server.stats()["batches"]
    print(f"\nserver batched {batches} segment buckets "
          f"for {len(tickets)} rollouts")
    return {"emit_steps": emit_steps, "bit_exact": exact,
            "final_steps": final_steps, "batches": batches,
            "plans": list(rplan.segment_plans), "server": server}


if __name__ == "__main__":
    main()
