"""Build the native libraries once, before any test module asks for them.

The JAX package compiles its LAS and LAZ codecs in place, next to their
sources, with no temporary name, so parallel pytest workers that built them
at once could load a half-written library (and skip or fail every test that
needs it).  Under an exclusive file lock the first process builds each
library and every other waits, then loads the finished one; the port's
libraries are built here too, once instead of once a worker.  pytest loads
this file before ``tests/conftest.py`` sets up JAX, so the packages are
imported inside the hook, which runs after it; their native modules import
no JAX.
"""

import fcntl
import os


def pytest_configure(config):
    from pointcloudhookup_tpu import native as jax_native
    from pointcloudhookup_tpu_torch import native as port_native

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "native-build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for get in (jax_native.get_lib, jax_native.get_laz_lib, port_native.get_lib,
                        port_native.get_laz_lib, port_native.get_prepare_lib,
                        port_native.get_encode_lib):
                get()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
