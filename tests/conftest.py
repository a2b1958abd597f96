"""Test environment: CPU backend with 8 virtual devices for mesh tests.

Mirrors the reference's TESTING/production config split (SURVEY.md §4): unit
tests run on a simulated 8-device mesh so multi-device sharding is
exercised without a cluster.  Tests marked `gpu` need a card and skip
elsewhere; on a GPU host run them with
`STPU_TEST_PLATFORM=cuda python -m pytest tests -m gpu`.
"""

import os

# The suite runs on the CPU unless STPU_TEST_PLATFORM names another
# platform (the `gpu`-marked tests).
os.environ["JAX_PLATFORMS"] = os.environ.get("STPU_TEST_PLATFORM", "cpu")
_ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
# Compact SHA compression bodies: ~4x less HLO per call site, same values
# (the unroll factor is a pure compile-time knob) — cold-machine compile
# time is the suite's dominant cost.
os.environ.setdefault("STPU_SHA_UNROLL", "1")
# Persistent compile cache, inherited by the tests' subprocesses: repeat
# suite runs on the same machine skip XLA recompilation.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache"),
)
flags = os.environ.get("XLA_FLAGS", "")
if _ON_CPU and "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if _ON_CPU:
    assert jax.device_count() >= 8, (
        f"need >= 8 virtual CPU devices for mesh tests, have "
        f"{jax.device_count()}"
    )

import pathlib  # noqa: E402

jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"

# Disk cache for own-prover proofs (tests/.proof_cache), keyed by a hash of
# every source file the prover's output depends on: proving at TESTING size
# costs minutes of CPU (compiles), and the proofs only change when the
# prover changes.  Shared with bench.py / __graft_entry__.py.
from stark_symphony.utils.proofcache import (  # noqa: E402
    cached_stwo_proof as _cached_stwo_proof,
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: PRODUCTION-size proving/verifying (minutes of CPU compile); "
        "deselect with -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: runs the compiled GPU kernels; skips without a GPU",
    )


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests unless JAX's backend is a GPU (decided here,
    at run time, never while test modules are imported)."""
    if request.node.get_closest_marker("gpu") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: STPU_TEST_PLATFORM=cuda python -m pytest "
                    "tests -m gpu")


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    return FIXTURES


@pytest.fixture(scope="session")
def own_testing_proof():
    """One TESTING-size proof from the in-tree stwo prover (verifies under
    full 'reference' linkage, unlike the external fixtures).  Disk-cached
    under tests/.proof_cache keyed by the prover sources' hash."""
    from stark_symphony.models.stwo.config import TESTING

    return _cached_stwo_proof(TESTING, "testing"), TESTING


@pytest.fixture(scope="session")
def production_proof():
    """One PRODUCTION-size proof from the in-tree stwo prover (shared by
    the slow tests; disk-cached like own_testing_proof)."""
    from stark_symphony.models.stwo.config import PRODUCTION

    return _cached_stwo_proof(PRODUCTION, "production"), PRODUCTION
