"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh with x64 enabled so
reference-semantics parity can be asserted at float64 tolerances.  These
environment variables must be set before jax is imported anywhere.  Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere (the ``gpu_device``
fixture decides at run time, never at import, so every xdist worker
collects the same tests).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def vorticity():
    """The seeded 256x512 barotropic vorticity snapshot on the
    Data/barotropic_vorticity.nc schema (utils.synth)."""
    from xcontour_tpu.utils import synth
    v, _ = synth.synth_barotropic_vorticity()
    return (np.asarray(v["latitude"], np.float64),
            np.asarray(v["longitude"], np.float64),
            np.asarray(v["absolute_vorticity"], np.float64))


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"] \
        if jax.default_backend() == "gpu" else []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return gpus[0]


@pytest.fixture()
def rng(request):
    """Per-test rng seeded from the test's node id.

    A session-scoped stream makes every test's draws depend on which tests
    ran before it — the source of a 1-in-N suite-order flake (round-3
    verdict item 2).  Deriving the seed from the node id makes each test's
    randomness identical under any collection order, -k selection, or
    parallel split, and still reproducible in isolation.
    """
    import zlib
    seed = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng(seed)


def pytest_collection_modifyitems(config, items):
    """Opt-in shuffled collection order (TEST_SHUFFLE_SEED=<int>) to prove
    order independence — the round-3 flake only appeared under full-suite
    ordering."""
    seed = os.environ.get("TEST_SHUFFLE_SEED")
    if seed:
        np.random.default_rng(int(seed)).shuffle(items)
