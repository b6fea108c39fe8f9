"""Test configuration.

Tests run on a virtual 8-device CPU mesh (the standard JAX pattern for
exercising multi-chip sharding without hardware) with x64 enabled so the
parity paths can match the reference's float64 arithmetic bit-for-bit.

``JAX_PLATFORMS`` and ``XLA_FLAGS`` are read once, when JAX first starts
a backend, and a plugin may import JAX before any conftest code runs.
So ``pytest_configure`` re-execs pytest exactly once with the CPU
platform and the 8-device flag set in the environment (stopping
pytest's fd capture first so the child inherits the real
stdout/stderr).  The persistent compilation cache is switched off: the
CLI enables it for users, and tests must neither read nor write it.

The re-exec also splits the suite across two xdist worker PROCESSES
(``-n 2 --dist loadfile``) when the user didn't pass their own ``-n``:
XLA's CPU compiler segfaults DETERMINISTICALLY (reproduced 4/4, jax 0.8
era) on whatever fresh compilation comes after ~115 tests' worth of
compiled programs accumulate in one process — the same compiles succeed
in fresher processes, ASan cleared the repo's own native code, and the
crash reproduces with the native library disabled.  Halving per-process
compile volume keeps the suite far from the threshold.
"""

import os
import sys

_NEEDS_REEXEC = os.environ.get("_AXCTD_TESTS_REEXECED") != "1"


def pytest_configure(config):
    if not _NEEDS_REEXEC:
        return
    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is not None:
        capman.stop_global_capturing()
    env = dict(os.environ)
    env["_AXCTD_TESTS_REEXECED"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    args = sys.argv[1:]
    if not any(a == "-n" or a.startswith("-n") and a[2:].isdigit()
               or a.startswith("--numprocesses") for a in args):
        args = ["-n", "2", "--dist", "loadfile"] + args
    os.execve(sys.executable, [sys.executable, "-m", "pytest"] + args, env)


if not _NEEDS_REEXEC:
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def default_drop():
    """One default synthetic AXCTD drop, shared across the session."""
    from axctdprocessor_tpu.models import simulator

    pcm, truth = simulator.synthesize()
    return pcm, truth


@pytest.fixture(scope="session")
def default_drop_wav(tmp_path_factory, default_drop):
    """The default drop written to a 16-bit WAV file."""
    from axctdprocessor_tpu.models import simulator

    pcm, truth = default_drop
    path = tmp_path_factory.mktemp("wav") / "default_drop.wav"
    simulator.write_wav(str(path), pcm, truth["spec"].fs)
    return str(path), truth


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
