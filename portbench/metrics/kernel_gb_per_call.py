"""Bytes the stencil kernels move a compiled call, in GB: the port's
``kernel.*`` spans (each launch's global loads and stores, from its launch
geometry: haloed slabs, aux tiles, tap tables, output) over the profiled
sub-window's ``stencil.call`` spans (``port_trace``)."""
from portbench import port_trace


def read(run):
    return port_trace.per_call_gb(run, port_trace.KERNEL)
