"""Host-side utilities."""

from pointcloudhookup_tpu_torch.utils.logging import Reporter  # noqa: F401
