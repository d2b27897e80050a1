"""How the port's CPU tests compile the JAX package's programs.

A test module that runs the reference imports
:func:`reference_compiles_in_process`: an autouse module fixture under
which JAX's persistent compilation cache is off (programs compile in the
test process; nothing is read from or written to the cache directory that
``tests/conftest.py`` shares between the pytest-xdist workers).  Loading
a cached XLA:CPU executable written by another worker killed workers of
a ``-n 6`` run of the suite with a segmentation fault inside
``deserialize_executable`` (``compiler._cache_read``) while port modules
ran the reference on the same programs the reference's own tests compile.
The process's cache settings, which an in-process reference driver run
also re-points (``enable_from_args``), are restored when the module ends.
"""

import contextlib

import jax
import pytest

#: the settings restored after a module: whether the persistent cache is
#: used, its directory, and the compile time above which it persists.
_SETTINGS = ("jax_enable_compilation_cache", "jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")


@contextlib.contextmanager
def without_persistent_cache():
    """JAX's persistent compilation cache off inside, the process's
    settings restored on exit."""
    from jax._src import compilation_cache

    prev = {k: getattr(jax.config, k) for k in _SETTINGS}
    jax.config.update("jax_enable_compilation_cache", False)
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def reference_compiles_in_process():
    with without_persistent_cache():
        yield
