"""Multi-rank extraction: the sharded step over torch.distributed
(``sharded``), its collectives (``group``) and a launcher of n ranks on one
host (``launch``)."""

from pointcloudhookup_tpu_torch.parallel.group import Group  # noqa: F401
from pointcloudhookup_tpu_torch.parallel.launch import call_on_rank, run_ranks  # noqa: F401
from pointcloudhookup_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_extract,
    tile_mesh,
)
