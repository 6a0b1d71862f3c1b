"""What the benchmark loads: never JAX or the JAX package (top-level
names compared whole; the port's name begins with the JAX package's), never
bench.py or benchmarks/, and in the reference nothing of the program."""

import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pointcloudhookup_tpu", "bench", "benchmarks"}


def loaded_top_level(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r}); {imports}; "
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_harness_loads_neither_jax_nor_the_jax_package():
    def modules(folder):
        return sorted(f[:-3] for f in os.listdir(os.path.join(harness.ROOT, "portbench", folder))
                      if f.endswith(".py") and f != "__init__.py")
    imports = "; ".join(
        ["import portbench.run, portbench.harness, portbench.drive, portbench.control",
         "import portbench.reference.exact, portbench.reference.fused",
         "from portbench.drive import make_entry",
         "import pointcloudhookup_tpu_torch.models.pipeline, pointcloudhookup_tpu_torch.core.streaming"]
        + [f"import portbench.metrics.{m}" for m in modules("metrics")]
        + [f"import portbench.entries.{m}" for m in modules("entries")])
    names = loaded_top_level(imports)
    assert "pointcloudhookup_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_level("import portbench.reference.exact, portbench.reference.fused, "
                             "portbench.reference.run_all, portbench.check, portbench.geo, "
                             "portbench.lasio, portbench.synthetic")
    assert not names & (FORBIDDEN | {"pointcloudhookup_tpu_torch", "torch"}), names
