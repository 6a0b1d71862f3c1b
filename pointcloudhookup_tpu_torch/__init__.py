"""PyTorch + CUDA port of pointcloudhookup_tpu, for NVIDIA Hopper (H100).

The JAX package ``pointcloudhookup_tpu`` is the reference this port is held
against; module names mirror it.  Importing this package imports torch and
never jax.  The host modules that import no JAX (``config``, ``io.las``,
``io.synthetic``, ``utils.logging``) are reused from the reference package.
"""
