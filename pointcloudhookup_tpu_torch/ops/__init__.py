"""Device compute on torch tensors; kernels live in ``ops.kernels``."""
