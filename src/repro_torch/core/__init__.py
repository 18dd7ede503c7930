"""Core host layers of the port: specs, covers, bands, halo, temporal
fusion, the engine, the planner and the plan cache.

    evolve / evolve_until                     -- repro_torch.core.time_stepper
"""
from repro_torch.core.time_stepper import evolve, evolve_until

__all__ = ["evolve", "evolve_until"]
