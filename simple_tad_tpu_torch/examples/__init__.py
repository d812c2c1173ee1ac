"""Examples of the port: the standalone plain-torch inference reference."""
