"""Model configurations of the port (the LM slice: Hymba-1.5B)."""
