"""Host-side utilities."""

from pointcloudhookup_tpu_torch.utils.logging import Reporter, StageTracer  # noqa: F401
