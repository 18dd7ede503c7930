"""Launch-side tools of the port: hardware constants, serving, the
planner's calibration and plan report, training."""
