"""PyTorch + CUDA port of pointcloudhookup_tpu, for NVIDIA Hopper (H100).

The JAX package ``pointcloudhookup_tpu`` is the reference this port is held
against; module names and the public names below mirror it.  The port
imports torch and nothing of the JAX package: the host modules it needs
(``config``, ``io.las``, ``io.laz``, ``io.geoid``, ``io.synthetic``,
``native``, ``utils.logging``, ``viz.boxes``, ``viz.export``) are copies.

Layering (bottom-up):
  core/      padded buffers, the resource governor, tile streaming
  io/        host-side codecs: LAS/LAZ, geoid grids, 7z, GIM container, CBM
  ops/       device compute on torch tensors; CUDA kernels in ops/kernels
  models/    tower schema, the extraction pipeline, GIM workflow, reports
  parallel/  the sharded step over torch.distributed
  viz/       display geometry, scene export, the offscreen renderer
  utils/     logging/progress plumbing, the tracer (spans, counters), validation
"""

__version__ = "0.1.0"

from pointcloudhookup_tpu_torch.config import (  # noqa: F401
    ExtractParams,
    MatchParams,
    VoxelParams,
)
