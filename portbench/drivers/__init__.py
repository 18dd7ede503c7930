"""One driver per kind of traffic (a mix's ``"kind"``): it sets up the
system under test for a cell, warms it, runs the measured window and
hands back what was timed, counted, traced and produced."""
