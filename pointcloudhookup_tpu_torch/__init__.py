"""PyTorch + CUDA port of pointcloudhookup_tpu, for NVIDIA Hopper (H100).

The JAX package ``pointcloudhookup_tpu`` is the reference this port is held
against; module names mirror it.  The port imports torch and nothing of
the JAX package: the host modules it needs (``config``, ``io.las``,
``io.laz``, ``io.synthetic``, ``native``, ``utils.logging``) are copies.
"""
