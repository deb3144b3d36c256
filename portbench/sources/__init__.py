"""Traffic sources, one module each, named by a mix's ``source``."""
