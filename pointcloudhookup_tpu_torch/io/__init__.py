"""Point-cloud I/O (copies of the JAX package's host modules)."""

from pointcloudhookup_tpu_torch.io.las import LasData, read_las, write_las  # noqa: F401
