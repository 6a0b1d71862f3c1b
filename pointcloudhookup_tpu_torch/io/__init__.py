"""Point-cloud I/O (copies of the JAX package's host modules)."""
