"""Display geometry, scene export and the offscreen renderer."""

from pointcloudhookup_tpu_torch.viz.boxes import (  # noqa: F401
    BBOX_PRESETS,
    adaptive_scale_for_height,
    box_lineset,
    expand_box_kuangxuan,
    get_bbox_preset,
    tower_display_geometries,
)
from pointcloudhookup_tpu_torch.viz.export import (  # noqa: F401
    colors_from_labels,
    export_scene_las,
    export_scene_ply,
    height_colors,
    read_ply_scene,
)
