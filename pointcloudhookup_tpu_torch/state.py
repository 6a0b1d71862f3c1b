"""Conversion between the JAX package's arrays (as numpy) and the port's
tensors.

The two packages meet only through numpy: stats dicts, OBB accumulator
dicts and the ``_cut`` intermediates of ``exact_extract_graph`` go through
``to_torch`` to feed a JAX result into a port stage, and port results come
back through ``to_numpy``, which counts each tensor it brings to the host
as one ``fetch`` (``utils/trace.py``).  Dtypes map bool -> bool, int32 -> int32,
float32 -> float32 and uint32 -> int64 (the port holds 32-bit keys in
int64); ``to_numpy(..., u32=...)`` narrows named entries back to uint32.
``extract_params_from_dict`` carries a JAX ``ExtractParams`` across: the
system has no weights, and its parameter tree is what both packages must
be handed identically.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
    TowerFilterParams,
)
from pointcloudhookup_tpu_torch.utils import trace

_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int64): torch.int64,
}


def to_torch(tree, device="cpu"):
    """numpy arrays / scalars (possibly nested in dicts, lists, tuples) ->
    torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype not in _TO_TORCH:
        raise TypeError(f"no tensor dtype for {arr.dtype}")
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device)


def to_numpy(tree, u32=()):
    """torch tensors (possibly nested) -> numpy arrays.  Entries of a dict
    whose key is in ``u32`` are narrowed to uint32."""
    if isinstance(tree, dict):
        return {
            k: (to_numpy(v).astype(np.uint32) if k in u32 else to_numpy(v, u32))
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v, u32) for v in tree)
    if isinstance(tree, torch.Tensor):
        trace.count("fetch")
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def extract_params_from_dict(tree: dict) -> ExtractParams:
    """The port's ExtractParams from the nested dict of a JAX
    ``ExtractParams`` (``dataclasses.asdict``).  A field that one package
    has and the other lacks raises TypeError."""
    tree = dict(tree)
    return ExtractParams(
        ground=GroundParams(**tree.pop("ground")),
        cluster=ClusterParams(**tree.pop("cluster")),
        filters=TowerFilterParams(**tree.pop("filters")),
        **tree,
    )
