"""Host wall a tile of models/pipeline.py compress (ops/voxel.py): the LAS
read, the voxel downsample on the device, the copies back and the LAS
write of the downsampled tile."""

LAYER = "models/pipeline.py compress"
UNIT = "ms"
MOVES = "mpts_per_s"
SPANS = {"compress": "pointcloudhookup_tpu_torch.models.pipeline:compress"}


def read(window):
    s = window.span_s("compress")
    return None if s is None else s * 1e3 / window.tiles
