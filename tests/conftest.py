"""Test harness config: CPU backend with 8 virtual devices + x64.

Tests always run on CPU (fast, deterministic, no GPU needed) with an 8-device
virtual mesh so the multi-device sharding paths compile and execute. float64
is enabled so the oracle comparisons can use exact double math; device-path
tests still request float32 explicitly to validate the production dtype.
What needs the GPU runs in chip_smoke.py, not here.
"""
import os

# force CPU before any backend starts (a plugin may already have imported
# jax, so set the config too, not only the environment)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# persistent XLA compilation cache (the suite is compile-bound): the
# programs' rule — JAX_COMPILATION_CACHE_DIR when set, else the
# gitignored <checkout>/.jax_cache
from openpbso_tpu.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

assert jax.default_backend() == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def synth_model_root(tmp_path_factory):
    from openpbso_tpu.utils.synth import synth_model_dir
    root = tmp_path_factory.mktemp("synth_model")
    synth_model_dir(str(root), "synth", num_modes=24, subdivisions=1,
                    ffat_n=12, seed=7)
    return str(root)


def db_error(test: np.ndarray, ref: np.ndarray) -> float:
    """20*log10(||err|| / ||ref||); -inf when both are silent."""
    ref_n = float(np.linalg.norm(ref))
    err_n = float(np.linalg.norm(np.asarray(test) - np.asarray(ref)))
    if ref_n == 0.0:
        return -np.inf if err_n == 0.0 else np.inf
    if err_n == 0.0:
        return -np.inf
    return 20.0 * np.log10(err_n / ref_n)


@pytest.fixture
def dberr():
    return db_error
