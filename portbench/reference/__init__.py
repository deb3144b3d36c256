"""Plain float32 references the benchmark holds the program to.  They
import neither JAX nor the JAX package nor anything of ``blendjax_torch``."""
