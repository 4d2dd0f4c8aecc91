"""One driver a kind of configuration (``config["driver"]``): it builds the
program as an operator starts it, runs the cell's traffic through it,
and compares what the timed path produced with the plain reference."""
