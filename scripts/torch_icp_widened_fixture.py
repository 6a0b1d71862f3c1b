"""Write the member clouds of the bench tile's towers whose ICP-refined
centre lies beyond 2 m of their member centroid, for
``tests/test_torch_registration.py::test_refine_widened_boxes_match_jax``.

It runs ``chip_smoke.py`` phase 10 (a)'s command through the PyTorch port:
``correct <gim> <las> --icp`` on the 4,194,304-point bench tile (seed 7,
the synthetic GIM with h = z - 25), and records the arguments of the
``refine_tower_centers`` call.  For each tower whose refined centre is
farther than TOWER_TOL_M (xy) from its member centroid it saves the member
cloud (float64, world), the box fields the refinement reads, the template
height and the refined centre.  Needs a CUDA card (the extraction is
full size):

    python3 scripts/torch_icp_widened_fixture.py [OUT.npz]

(default ``tests/fixtures/torch_icp_widened.npz``).
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from pointcloudhookup_tpu_torch.__main__ import main as cli  # noqa: E402
from pointcloudhookup_tpu_torch.models import refine  # noqa: E402


def main(argv) -> int:
    out_path = argv[0] if argv else os.path.join(ROOT, "tests", "fixtures",
                                                 "torch_icp_widened.npz")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    pts, centers = chip_smoke.corridor_tile(chip_smoke.N_POINTS, chip_smoke.SEED)
    calls = []
    fn = refine.refine_tower_centers

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    refine.refine_tower_centers = record
    try:
        with tempfile.TemporaryDirectory(prefix="icp_fixture_") as tmp:
            las_path, gim_path, _, _, _, _ = chip_smoke.gim_files(tmp, pts, centers)
            with contextlib.redirect_stdout(io.StringIO()):
                cli(["correct", gim_path, las_path, "--icp", "--device", "cuda",
                     "--output-folder", os.path.join(tmp, "o")])
    finally:
        refine.refine_tower_centers = fn
    (towers, clouds, pair_idx), kwargs, res = calls[0]
    arrays = dict(iters=kwargs.get("iters", 30),
                  max_corr_dist=kwargs.get("max_corr_dist", 2.0))
    far = []
    for pi, r in sorted(res.items()):
        off = float(np.linalg.norm(r["center"][:2] - clouds[pi].mean(axis=0)[:2]))
        if off <= chip_smoke.TOWER_TOL_M:
            continue
        t = towers[pi]
        th = (kwargs.get("template_params") or {}).get(pi, (None, None))
        far.append(pi)
        print(f"tower {pi}: {len(clouds[pi])} member points, refined centre {off:.3f} m "
              f"from the member centroid, box {t.extent}, template height {th[0]}")
        for key, val in dict(
                cloud=np.asarray(clouds[pi], np.float64), center=t.center, extent=t.extent,
                height=t.height, width=t.width, north_angle=t.north_angle, angle=t.angle,
                num_points=t.num_points, label=t.label,
                template_height=np.nan if th[0] is None else float(th[0]),
                card_center=r["center"]).items():
            arrays[f"t{pi}_{key}"] = np.asarray(val)
    arrays["towers"] = np.array(far, np.int64)
    np.savez_compressed(out_path, **arrays)
    print(f"{len(far)} towers beyond {chip_smoke.TOWER_TOL_M} m: {far} -> {out_path} "
          f"({os.path.getsize(out_path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
