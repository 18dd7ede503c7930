"""Model configurations of the port: the LM slice (Hymba-1.5B) and the
paper's stencil cases."""
