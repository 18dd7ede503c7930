"""The pads' share of the card's HBM bandwidth: the port's ``halo.pad``
bytes over their device time (the spans' CUDA events), against
``peaks.json``'s ``hbm_bytes_per_s``; None off the card, where the pads
are untimed (``port_trace``)."""
from portbench import port_trace, yardstick


def read(run):
    s = port_trace.session(run)
    pad = s.get(port_trace.PAD) if s else None
    if not pad or not pad["device_s"]:
        return None
    import torch
    if not torch.cuda.is_available():
        return None
    peaks = yardstick.card_peaks(torch.cuda.get_device_name())
    if peaks is None:
        return None
    return 100.0 * pad["bytes"] / pad["device_s"] / peaks["hbm_bytes_per_s"]
