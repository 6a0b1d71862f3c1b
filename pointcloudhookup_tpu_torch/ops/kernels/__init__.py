"""Hand-written CUDA kernels (sources in ``pointcloudhookup_tpu_torch/csrc``)
with their plain PyTorch versions.  Each wrapper runs the plain version for
CPU tensors and launches its kernel for CUDA tensors; the library is built
at the first launch (``build.py``).  Each call that launches its kernel adds
one to the counter ``kernel.<function>`` (``utils/trace.py``); a call with no
rows, which launches nothing, adds none.  ``nearest`` (ICP's sweep, which
replaces no TPU kernel) counts ``icp.nearest_kernel`` instead, so that
``kernel.*`` stays the ten TPU kernels' counterparts."""
