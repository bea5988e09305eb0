"""Test configuration.

Tests run on CPU (deterministic, x64-capable) with 8 virtual devices so the
multi-device sharding paths can be exercised without accelerators.  Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on the card
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (any
``JAX_PLATFORMS`` the caller sets is kept).  ``chip_smoke.py`` and
``bench.py`` exercise the GPU path end to end.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
# One BLAS thread per test process: the suite runs in several worker
# processes, and multi-threaded OpenBLAS in each spin-waits against the
# others -- a dense 280x280 batched LAPACK solve went from 8 s alone to
# over 400 s with six workers, and to 15 s with one thread each.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (the >60s integration tier: the reference "
        "suites under the stub, 1000-step MPC episodes, feeder141-scale "
        "solves).  CI runs both tiers; the default local loop stays fast.",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: >60s integration test (deselected by default; --runslow or GYM_ANM_TPU_SLOW=1)"
    )
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips elsewhere; see the module docstring)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("GYM_ANM_TPU_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: pass --runslow (or GYM_ANM_TPU_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX has none.  Decided here, at
    run time, never while test modules are imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def reference():
    """Import the reference gym-anm from /root/reference with stub modules
    for its unavailable deps (cvxpy -> exact-QP stub, websocket_server).

    The cvxpy stub solves the reference's projection QPs *exactly* (the
    feasible sets are small 2-D polytopes), so reference trajectories are
    reproduced to float64 precision rather than ECOS's ~1e-8.
    """
    ref_path = "/root/reference"
    if not os.path.isdir(os.path.join(ref_path, "gym_anm")):
        pytest.skip("reference repo not available")
    from tests import cvxpy_stub

    sys.modules.setdefault("cvxpy", cvxpy_stub)
    sys.modules.setdefault("websocket_server", cvxpy_stub.FakeWebsocketServerModule())
    if ref_path not in sys.path:
        sys.path.insert(0, ref_path)
    import gym_anm  # noqa: F401

    return gym_anm
