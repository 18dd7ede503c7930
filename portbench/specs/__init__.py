"""The program's side of a configuration: ``specs/<name>.py`` builds the
port's operator from the configuration's numbers, found by the
configuration's ``"spec"`` key."""
