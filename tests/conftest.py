"""Test configuration: an 8-device virtual CPU platform by default.

Multi-chip sharding paths are exercised on a virtual device mesh
(SURVEY.md section 4, item 4): 8 CPU devices via XLA_FLAGS, so `Mesh`/
`shard_map`/halo-exchange tests run anywhere. Must be set before JAX import.
An explicit JAX_PLATFORMS (e.g. cuda, for the `gpu`-marked tests) wins.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


CALIB_DIRS = {
    "320x240": "/root/reference/backup/320x240",
    "640x480": "/root/reference/backup/640x480",
    "1280x720": "/root/reference/backup/1280x720",
}


@pytest.fixture(params=list(CALIB_DIRS))
def calib_dir(request):
    import os.path

    path = CALIB_DIRS[request.param]
    if not os.path.isdir(path):
        pytest.skip("reference calibration data not available")
    return path


# Persistent compilation cache: the suite is compile-dominated (shard_map
# meshes, Pallas interpret graphs), so warm runs are several times faster.
# Same policy as every entry point (JAX_COMPILATION_CACHE_DIR wins).
from rt_depth_map.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()



@pytest.fixture
def gpu():
    """Skips a card-only test unless JAX's default backend is a GPU (run
    them there with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")
