"""Step functions of the port (serving steps so far)."""
