"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` is the command; this module is what it runs, importable by the
tests.  Everything a cell needs is found by name from ``BENCHMARK.json``:
the configuration file it names, ``traffic/<traffic>.json``, the entry
kind that mix names (``entries/<entry>.py``, see ``drive.py``), and
``metrics/<metric>.py`` for each per-layer metric and each end-to-end
metric the harness does not take itself.  A traced run reads every
per-layer metric of ``BENCHMARK.json``; a reader that finds nothing to
read in the cell returns None and is left out of the line, so a new cell
reports every existing metric that applies to it with no entry edited.

The window is a closed loop of requests.  It closes at the first request
that completes after ``--seconds`` have passed, so no request is cut; a
rate divides the work of every request completed in the window by the time
from the window's start to that completion.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` is a run of its own under
``torch.profiler`` with spans (``spans.py``) and reports the per-layer
metrics, ``busy_s`` and ``window_s`` and a ``breakdown``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

from portbench import check as checking
from portbench import profiling, roofline
from portbench.drive import make_entry
from portbench.spans import Recorder

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pointcloudhookup_tpu")


class Unavailable(RuntimeError):
    """The machine lacks what the cell needs; no result is printed."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: str = ROOT) -> dict:
    """The cell, its configuration and mix, and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json"))

    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", (workload,))]
    per_layer = list(bench["per_layer"])
    modules = {m["name"]: importlib.import_module(f"portbench.metrics.{m['name']}")
               for m in per_layer + end_to_end if m["name"] not in END_TO_END}
    return dict(bench=bench, cell=cell, config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer, modules=modules)


def use_checkout_caches(root: str = ROOT) -> None:
    """Every compile cache at a fixed path inside the checkout.  The
    program's own (build/torch_kernels, build/native) already are."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Unavailable("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < n:
        raise Unavailable(f"the cell needs {n} cards, this machine has "
                          f"{torch.cuda.device_count()}")


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Window:
    """What the per-layer readers see: the requests, spans, kernel calls
    and trace of the measured window."""

    def __init__(self, requests, elapsed_s, recorder, trace):
        self.requests = requests
        self.elapsed_s = elapsed_s
        self.spans = recorder.spans
        self.kernel_costs = recorder.kernel_costs
        self.trace = trace
        self.tiles = sum(len(r.tiles) for r in requests)

    def span_s(self, name: str) -> float | None:
        got = self.spans.get(name)
        return sum(t1 - t0 for t0, t1 in got) if got else None


WARMUP_REQUESTS = 1  # the cell's own shapes, once, before the window

END_TO_END = {
    "mpts_per_s": lambda w, setup, peak: sum(r.points for r in w.requests) / w.elapsed_s / 1e6,
    "peak_device_mib": lambda w, setup, peak: peak / 2**20,
    "setup_s": lambda w, setup, peak: setup,
}


def reference_for(entry):
    """The plain reference of a cell: the entry kind's ``REFERENCE``, else
    the configuration's ``reference``."""
    name = entry.REFERENCE or entry.config["reference"]
    return importlib.import_module(f"portbench.reference.{name}")


def check_window(entry, requests, config: dict) -> dict:
    """Hold every tile the window returned against the reference, run once
    a distinct tile."""
    ref_mod = reference_for(entry)
    refs = {}
    per_tile = []
    for req in requests:
        for k, t in enumerate(req.tiles):
            if t not in refs:
                refs[t] = checking.from_reference(
                    ref_mod.run(entry.reference_input(t), entry.config))
            got = entry.form(req.outputs[k]) if k < len(req.outputs) else None
            per_tile.append(checking.compare(got, refs[t]))
    return checking.judge(per_tile, config["check"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, workdir: str | None = None, root: str = ROOT,
             info: dict | None = None) -> dict:
    """One run; returns the result object of the last line."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    info = info or resolve(workload, root)
    cell, config = info["cell"], info["config"]
    on_card = device != "cpu"
    if on_card:
        require_cards(cell["chips"])
    import tempfile

    workdir = workdir or os.path.join(tempfile.gettempdir(), f"portbench-{workload}")
    entry = make_entry(config, info["traffic"], seed, device, workdir)
    try:
        entry.prepare()
        for i in range(WARMUP_REQUESTS):
            entry.request(i)
        modules = [info["modules"][m["name"]] for m in info["per_layer"]] if trace else ()
        span_targets = {}
        for mod in modules:
            span_targets.update(getattr(mod, "SPANS", {}))
        kernels = roofline.FUNCTIONS if any(getattr(m, "KERNELS", False) for m in modules) else {}
        recorder = Recorder(tracing=trace)
        entry.tracing = trace
        prof = contextlib.nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        requests = []
        with entry.window(), recorder.wrapped(span_targets, kernels), prof as p:
            with recorder.span("window"):
                t0 = time.perf_counter()
                while True:
                    with recorder.span("request"):
                        requests.append(entry.request(len(requests)))
                    elapsed = time.perf_counter() - t0
                    if elapsed >= seconds:
                        break
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        parsed = None
        if trace:
            path = os.path.join(workdir, "trace.json")
            p.export_chrome_trace(path)
            parsed = profiling.Trace.load(path)
            os.remove(path)
        window = Window(requests, elapsed, recorder, parsed)
        if trace:
            metrics = {}
            for m in info["per_layer"]:
                value = info["modules"][m["name"]].read(window)
                if value is not None:
                    metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        else:
            metrics = {}
            for m in info["end_to_end"]:
                if m["name"] in END_TO_END:
                    value = END_TO_END[m["name"]](window, setup_s, peak)
                else:
                    value = info["modules"][m["name"]].read(window)
                if value is not None:
                    metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
        dev = dict(platform="gpu" if on_card else "cpu",
                   kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                   count=cell["chips"], memory_peak_bytes=int(peak))
        if on_card:
            dev["power_limit"] = power_limit()
        breakdown = None
        if trace and parsed is not None:
            dev["busy_s"] = parsed.busy_s()
            dev["window_s"] = parsed.window_s()
            breakdown = dict(device_ops=parsed.top_ops(10), idle_gaps=parsed.idle_gaps(10))
        if on_card:
            torch.cuda.empty_cache()
        ladders = {r.tiles[0]: r.outputs[0]["ladder"] for r in requests
                   if r.outputs and r.outputs[0].get("ladder")}
        if ladders:
            print(f"portbench: ladder a tile {ladders}", file=sys.stderr)
        t_check = time.perf_counter()
        verdict = check_window(entry, requests, config)
        print(f"portbench: set-up {setup_s:.3f} s, window {elapsed:.3f} s ({len(requests)} "
              f"requests), check {time.perf_counter() - t_check:.3f} s; request ms "
              f"{[(r.tiles[0], round(r.wall_s * 1e3, 1)) for r in requests]}", file=sys.stderr)
    finally:
        entry.cleanup()
    result = dict(correct=verdict["ok"], attempted=window.tiles, failed=verdict["failed"],
                  metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: dict(value=v, limit=config["check"][n])
                       for n, v in verdict["worst"].items()}
    return result
