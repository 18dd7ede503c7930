"""Core host layers of the port: specs, covers, bands, halo, temporal
fusion, the engine and the planner."""
