"""Plain references the benchmark's comparison holds the program against;
a configuration names its own in ``"reference"``."""
