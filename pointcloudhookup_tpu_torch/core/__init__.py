"""Host-side buffer helpers, the resource governor and tile streaming."""

from pointcloudhookup_tpu_torch.core.batch import (  # noqa: F401
    PointBatch,
    pad_points,
    round_up,
)
