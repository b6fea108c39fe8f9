"""Entry-point robustness: the dry run and the bench.

- ``__graft_entry__.dryrun_multichip`` decides from the environment
  alone whether to re-launch itself on a virtual CPU mesh: importing jax
  and starting a backend in the parent would take the accelerator (a GPU
  backend reserves most of the card's memory) and cannot be undone.
- ``bench.py`` bounds hung children, skips children past its deadline,
  and always prints one JSON line of record.

The poisoned-jax test runs the REAL ``dryrun_multichip`` bootstrap
decision with a fake ``jax`` module on PYTHONPATH that explodes on
import — if any parent-process code path touches jax before re-launching
on the CPU mesh, it fails loudly.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__ as graft  # noqa: E402


def _with_env(monkeypatch, **env):
    for k in ("_AXCTD_DRYRUN_BOOTSTRAPPED", "PYTHONPATH", "JAX_PLATFORMS",
              "XLA_FLAGS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


class TestNeedsBootstrap:
    def test_tpu_platform_bootstraps(self, monkeypatch):
        _with_env(monkeypatch, JAX_PLATFORMS="cuda")
        assert graft._needs_bootstrap(8) is True

    def test_cpu_mesh_big_enough_runs_in_process(self, monkeypatch):
        _with_env(monkeypatch, JAX_PLATFORMS="cpu",
                  XLA_FLAGS="--xla_force_host_platform_device_count=8")
        assert graft._needs_bootstrap(8) is False
        assert graft._needs_bootstrap(4) is False

    def test_cpu_mesh_too_small_bootstraps(self, monkeypatch):
        _with_env(monkeypatch, JAX_PLATFORMS="cpu",
                  XLA_FLAGS="--xla_force_host_platform_device_count=4")
        assert graft._needs_bootstrap(8) is True

    def test_no_flags_bootstraps(self, monkeypatch):
        _with_env(monkeypatch)
        assert graft._needs_bootstrap(8) is True

    def test_bootstrapped_flag_wins(self, monkeypatch):
        _with_env(monkeypatch, _AXCTD_DRYRUN_BOOTSTRAPPED="1",
                  JAX_PLATFORMS="cuda")
        assert graft._needs_bootstrap(8) is False

    def test_decision_never_imports_jax(self, monkeypatch):
        """The decision path must not import jax at all: a backend
        started in the parent would hold the accelerator."""
        _with_env(monkeypatch, JAX_PLATFORMS="cuda")
        monkeypatch.setitem(sys.modules, "jax", None)  # import would raise
        assert graft._needs_bootstrap(8) is True


def test_dryrun_bootstrap_with_poisoned_backend(tmp_path):
    """``dryrun_multichip`` must reach its CPU-mesh re-launch without
    importing jax in the parent process.

    A fake ``jax`` module that raises on import sits first on
    PYTHONPATH, and the environment names a GPU platform.  The parent
    must not trip it.  The child itself is stubbed (we assert the
    LAUNCH happens with the CPU-mesh environment — the real 8-device
    decode is covered by the parallel tests)."""
    poison = tmp_path / "poisoned_site"
    poison.mkdir()
    (poison / "jax.py").write_text(
        "raise RuntimeError('poisoned backend touched in parent process')")
    driver = tmp_path / "drive.py"
    driver.write_text(textwrap.dedent("""
        import os, sys
        sys.path.insert(0, %r)
        import __graft_entry__ as g

        launched = {}
        def fake_run(cmd, env=None, cwd=None, **kw):
            assert env.get("JAX_PLATFORMS") == "cpu"
            assert "xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
            launched["ok"] = True
            class P: returncode = 0
            return P()
        g.subprocess.run = fake_run
        g.dryrun_multichip(8)
        assert launched.get("ok"), "bootstrap subprocess never launched"
        import jax  # noqa: F401 -- MUST raise: poisoned module on path
    """) % REPO)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{poison}"
    env["JAX_PLATFORMS"] = "cuda"
    env.pop("_AXCTD_DRYRUN_BOOTSTRAPPED", None)
    proc = subprocess.run([sys.executable, str(driver)], env=env,
                          capture_output=True, text=True, timeout=120)
    # the final poisoned import proves the fake jax was live the whole
    # time; everything before it must have succeeded without tripping it
    assert "poisoned backend touched in parent process" in proc.stderr
    assert "bootstrap subprocess never launched" not in proc.stderr
    assert "AssertionError" not in proc.stderr


class TestBenchOutageHandling:
    """A hung or failing child must not take the bench down."""

    def test_run_child_converts_hang_to_runtimeerror(self, monkeypatch):
        import bench

        def always_hang(cmd, timeout=None, **kw):
            raise subprocess.TimeoutExpired(cmd, timeout)

        monkeypatch.setattr(bench.subprocess, "run", always_hang)
        with pytest.raises(RuntimeError, match="hung"):
            bench._run_child("single_auto", timeout=1.0)

    def test_try_child_returns_none_on_persistent_failure(self, monkeypatch):
        import bench

        def always_hang(cmd, timeout=None, **kw):
            raise subprocess.TimeoutExpired(cmd, timeout)

        monkeypatch.setattr(bench.subprocess, "run", always_hang)
        assert bench._try_child("single_auto", attempts=2,
                                timeout=1.0) == {}

    def test_run_child_parses_agreement(self, monkeypatch):
        import bench

        def fake_run(cmd, timeout=None, **kw):
            class P:
                returncode = 0
                stdout = "warm\nWALL 1.25 FRAMES 1500 WIRE int4-ns AGREE 0.9987\n"
                stderr = ""
            return P()

        monkeypatch.setattr(bench.subprocess, "run", fake_run)
        rec = bench._run_child("single_auto")
        assert rec == {"wall": 1.25, "frames": 1500.0, "wire": "int4-ns",
                       "agree": 0.9987}

    def test_run_child_parses_tput(self, monkeypatch):
        import bench

        def fake_run(cmd, timeout=None, **kw):
            class P:
                returncode = 0
                stdout = "WALL 0.15 FRAMES 1500 AGREE 1.0000 TPUT 0.1200\n"
                stderr = "#CHILD {\"mode\": \"resident\"}\n"
            return P()

        monkeypatch.setattr(bench.subprocess, "run", fake_run)
        rec = bench._run_child("resident")
        assert rec["wall"] == 0.15 and rec["agree"] == 1.0
        assert rec["tput"] == 0.12 and "wire" not in rec


class TestBenchDeadline:
    """The global-deadline SLO: children must be skipped when they no
    longer fit, partials must flush after every child, and a kill signal
    must still print the final JSON line."""

    def test_try_child_skips_past_deadline(self, monkeypatch):
        import bench

        calls = {"n": 0}

        def no_run(cmd, timeout=None, **kw):
            calls["n"] += 1
            raise AssertionError("child launched past the deadline")

        monkeypatch.setattr(bench.subprocess, "run", no_run)
        monkeypatch.setattr(bench, "_remaining", lambda: 30.0)
        monkeypatch.setitem(bench.RESULT, "skipped", [])
        out = bench._try_child("corpus", est_s=240.0)
        assert out == {}
        assert calls["n"] == 0
        assert "corpus" in bench.RESULT["skipped"]

    def test_emit_partial_then_final(self, monkeypatch, capsys):
        import bench

        monkeypatch.setattr(bench, "_FINAL_PRINTED", False)
        monkeypatch.setattr(bench, "RESULT",
                            {"wall_auto": 1.2, "agree_auto": 1.0})
        bench._emit(final=False)
        cap = capsys.readouterr()
        assert cap.out == ""  # partials never pollute the stdout line
        assert cap.err.startswith("# partial ")
        import json as _json

        partial = _json.loads(cap.err.split("# partial ", 1)[1])
        assert partial["value"] == 500.0

        bench._emit(final=True)
        bench._emit(final=True)  # idempotent: exactly one line of record
        cap = capsys.readouterr()
        assert cap.out.count("\n") == 1
        final = _json.loads(cap.out)
        assert final["value"] == 500.0
        assert final["single_wall_s"] == 1.2
