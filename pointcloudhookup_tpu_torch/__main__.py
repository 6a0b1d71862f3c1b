"""Command-line entry point: ``python -m pointcloudhookup_tpu_torch extract``.

The ``extract`` subcommand takes the JAX package's arguments
(``pointcloudhookup_tpu/cli.py``) plus ``--device``.
"""

from __future__ import annotations

import argparse


def cmd_extract(args):
    from pointcloudhookup_tpu_torch.config import (
        ClusterParams,
        ExtractParams,
        TowerFilterParams,
    )
    from pointcloudhookup_tpu_torch.models.pipeline import extract

    params = None
    if args.per_chunk or args.cluster_method != "auto":
        params = ExtractParams(
            cluster=ClusterParams(
                eps=args.eps, min_points=args.min_points,
                per_chunk=args.per_chunk, method=args.cluster_method,
            ),
            filters=TowerFilterParams(
                aspect_ratio_threshold=args.aspect_ratio_threshold,
                min_height=args.min_height,
                max_width=args.max_width,
                min_width=args.min_width,
                duplicate_threshold=args.duplicate_threshold,
            ),
        )
    towers = extract(
        args.las,
        log_callback=print,
        eps=args.eps,
        min_points=args.min_points,
        aspect_ratio_threshold=args.aspect_ratio_threshold,
        min_height=args.min_height,
        max_width=args.max_width,
        min_width=args.min_width,
        duplicate_threshold=args.duplicate_threshold,
        params=params,
        output_dir=args.output_dir,
        excel_path=args.excel,
        device=args.device,
    )
    for t in towers:
        print(
            f"{t.id}: center=({t.center[0]:.2f},{t.center[1]:.2f},{t.center[2]:.2f}) "
            f"h={t.height:.1f} w={t.width:.1f} north={t.north_angle:.1f} pts={t.num_points}"
        )


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="pointcloudhookup_tpu_torch",
        description="Power-line tower extraction on PyTorch + CUDA.",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("extract", help="extract towers from a LAS tile")
    sp.add_argument("las")
    sp.add_argument("--eps", type=float, default=8.0)
    sp.add_argument("--min-points", type=int, default=80)
    sp.add_argument("--aspect-ratio-threshold", type=float, default=0.8)
    sp.add_argument("--min-height", type=float, default=15.0)
    sp.add_argument("--max-width", type=float, default=50.0)
    sp.add_argument("--min-width", type=float, default=8.0)
    sp.add_argument("--duplicate-threshold", type=float, default=30.0)
    sp.add_argument(
        "--cluster-method", default="auto",
        choices=["auto", "exact", "grid", "adaptive"],
        help="clustering backend; 'adaptive' derives eps from the data "
             "(the reference's HDBSCAN-path analogue)",
    )
    sp.add_argument("--output-dir", help="save per-tower LAS files here")
    sp.add_argument("--excel", help="towers_info table path")
    sp.add_argument(
        "--per-chunk", action="store_true",
        help="reference-parity per-50k-chunk clustering (labels never merge across chunks)",
    )
    sp.add_argument(
        "--device", default="cuda",
        help="torch device to run on, e.g. cuda, cuda:1 or cpu",
    )
    sp.set_defaults(fn=cmd_extract)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
