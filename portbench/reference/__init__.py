"""Plain references the benchmark holds the program's outputs against.

They import neither JAX, the JAX package, nor anything of the port.
"""
