"""Bytes the pad layer moves a compiled call, in GB: the port's
``halo.pad`` spans (each periodic gather's or zero pad's input and output,
each once) over the profiled sub-window's ``stencil.call`` spans
(``port_trace``)."""
from portbench import port_trace


def read(run):
    return port_trace.per_call_gb(run, port_trace.PAD)
