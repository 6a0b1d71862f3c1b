"""Start n ranks on one host, one process each.

Counterpart of ``__graft_entry__.py::_reexec_dryrun`` (which re-runs the
JAX dry run in a fresh interpreter with n virtual devices): here every
rank is a spawned process that sets up the default process group through
a ``FileStore`` in a temporary directory (no network, no port to clash
with another run), takes one CPU thread, selects its device and calls the
target.  The caller names the backend and each rank's device; nothing is
switched behind its back: NCCL needs a card per rank, and several ranks
may share a card only over gloo.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from pointcloudhookup_tpu_torch.state import to_numpy, to_torch


def _rank_devices(devices, n: int) -> list[str]:
    """Each rank's device: ``cuda:r`` for rank r by default, one name for
    every rank, or a list of n names."""
    if devices is None:
        return [f"cuda:{r}" for r in range(n)]
    if isinstance(devices, (str, torch.device)):
        return [str(devices)] * n
    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    return devices


def _check(backend: str, devices: list[str]) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    cards = [torch.device(d) for d in devices if torch.device(d).type == "cuda"]
    if backend == "nccl":
        if len(cards) != len(devices):
            raise ValueError("the nccl backend needs a CUDA device for every rank")
        if len({c.index or 0 for c in cards}) != len(cards):
            raise ValueError("nccl needs a card of its own for every rank")
    if cards and not torch.cuda.is_available():
        raise RuntimeError(f"devices {devices} need CUDA, which is not available")
    if backend == "nccl" and torch.cuda.device_count() < len(devices):
        raise RuntimeError(
            f"nccl with {len(devices)} ranks needs {len(devices)} cards, "
            f"{torch.cuda.device_count()} found (ranks may share a card over gloo)"
        )


def _rank_main(rank, n, backend, device, store_path, timeout_s, args_path, results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        with open(args_path, "rb") as f:
            target, args = pickle.load(f)
        try:
            results.put(("ok", rank, target(dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put(("error", rank, traceback.format_exc()))


def run_ranks(target, rank_args, *, backend: str = "nccl", devices=None,
              timeout: float = 1800.0) -> list:
    """Run ``target(device, *rank_args[r])`` on ranks r = 0..n-1, each in a
    spawned process inside one default process group, and return the
    results in rank order.  target and its arguments and result are
    pickled: a function of an importable module, numpy arrays and plain
    values (``state.extract_params_from_dict`` carries parameters).
    Kernels are built here once, before the ranks start, so that they only
    load them.  Raises with the rank's traceback if any rank fails, and
    stops every rank on a failure or after ``timeout`` seconds."""
    n = len(rank_args)
    devices = _rank_devices(devices, n)
    _check(backend, devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        from pointcloudhookup_tpu_torch.ops.kernels import build

        build.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = [None] * n
    with tempfile.TemporaryDirectory(prefix="pch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        # the arguments go through files: a spawned child reads its process
        # arguments only once its interpreter is up, so large ones would hold
        # the parent at each start in turn
        procs = []
        for r in range(n):
            args_path = os.path.join(tmp, f"args{r}.pkl")
            with open(args_path, "wb") as f:
                pickle.dump((target, tuple(rank_args[r])), f, protocol=pickle.HIGHEST_PROTOCOL)
            procs.append(ctx.Process(
                target=_rank_main,
                args=(r, n, backend, devices[r], store, timeout, args_path, results),
                daemon=True,
            ))
        for p in procs:
            p.start()
        failed = True
        deadline = time.monotonic() + timeout
        try:
            done = 0
            while done < n:  # drain before joining
                try:
                    status, rank, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and out[r] is None]
                    if dead:  # died without a word (a native abort)
                        raise RuntimeError(f"rank {dead[0]} of {n} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks did not finish within {timeout} s") \
                            from None
                    continue
                if status != "ok":
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = value
                done += 1
            failed = False
        finally:
            for p in procs:
                if failed:  # the others may wait in a collective forever
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out


def call_on_rank(device, calls):
    """A target for run_ranks: each (fn, args, kwargs) of ``calls`` runs as
    ``fn(*args, group=group, **kwargs)`` with the group of all ranks; with a
    fourth item, step_args, what it returns is called on them in turn
    (``(make_sharded_extract, (), options, (xyz, mask))`` builds this rank's
    step and runs it once).  Numpy arrays among args and step_args move to
    ``device`` as tensors; the results come back as numpy."""
    from pointcloudhookup_tpu_torch.parallel.sharded import tile_mesh

    group = tile_mesh()

    def on_device(values):
        return [to_torch(a, device) if isinstance(a, np.ndarray) else a for a in values]

    out = []
    for fn, args, kwargs, *step_args in calls:
        res = fn(*on_device(args), group=group, **kwargs)
        for sargs in step_args:
            res = res(*on_device(sargs))
        out.append(to_numpy(res))
    return out
