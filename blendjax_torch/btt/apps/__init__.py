"""Command-line apps of the port's consumer side."""
