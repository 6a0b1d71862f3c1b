"""Tower schema, the extraction pipeline, the GIM workflow and reports."""

from pointcloudhookup_tpu_torch.models.towers import (  # noqa: F401
    Tower,
    extract_step,
    filter_and_dedup,
)
