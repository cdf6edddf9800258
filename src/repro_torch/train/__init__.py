"""Step functions of the port (serving steps only, so far)."""
