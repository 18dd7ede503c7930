"""Set-up: seconds from the process's start to the first timed call,
kernel builds, planning, compiling, inputs and warm-up included."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
