"""Launch-side records of the port (hardware constants)."""
