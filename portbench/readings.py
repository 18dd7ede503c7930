"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process: for each seed a fresh set of inputs, a short
window of the timed path, and what the reference's ``checks`` returns
over the answers it kept:

* ``program``: the numbers the run compares, the lower readings;
* ``control``: the same with each of the reference's lower precisions in
  the program's place, the upper readings;
* ``info``: what the reference records beside them, such as what an
  answer left unchanged would read.

    python portbench/readings.py --workload star2d_r2.rollout \\
        --seeds 101-112 --seconds 3

One JSON line a seed on standard output.
"""
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:] = [str(_HERE.parent), str(_HERE.parent / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != _HERE]


def seeds_arg(text: str) -> list[int]:
    """``"3,5,9-12"`` -> ``[3, 5, 9, 10, 11, 12]``."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from portbench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds_arg, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        # as in a run: the program's state is freed before the reference
        system = harness.driver_for(cell).System(cell, device)
        system.inputs(seed)
        system.warm()
        if i == 0:
            for line in system.describe():
                print(line, file=sys.stderr)
        record = harness.RunRecord(cell=cell)
        system.window(record, args.seconds, False, seed, time.perf_counter())
        answers = system.answers()
        system.release()
        del system
        torch.cuda.empty_cache()
        program, info = harness.compare(cell, answers, None, device)
        control = {c: harness.compare(cell, answers, c, device)[0]
                   for c in harness.reference_for(cell).CONTROLS}
        print(json.dumps({
            "workload": cell.name, "seed": seed, "answers": len(answers),
            "attempted": record.attempted, "failed": record.failed,
            "program": program, "control": control, "info": {
                k: v for k, v in {**record.info, **info}.items()
                if isinstance(v, (int, float))}}), flush=True)
        del answers
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
