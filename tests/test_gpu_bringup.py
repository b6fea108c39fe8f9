"""The GPU entry points, as far as the CPU can check them.

``chip_smoke.py`` and ``bench.py`` must refuse to run without a GPU;
the smoke's verdict line carries exactly the keys of its contract; the
compile cache is placed from outside; the pinned-precision tone products
hold their stated tolerance against float64; and nothing in the package
is written for a TPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / script)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert not proc.stdout.strip(), proc.stdout  # nothing timed or printed


def test_contract_line_keys():
    import jax

    line = json.loads(chip_smoke.contract_line(jax.devices()))
    assert line == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}


@pytest.mark.parametrize("from_env", [True, False],
                         ids=["env_var", "checkout_default"])
def test_compile_cache_dir(from_env, monkeypatch, tmp_path):
    import jax

    from axctdprocessor_tpu.utils import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.chdir(tmp_path)
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert "jax_compilation_cache_dir" not in updates  # JAX reads it
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
        assert cache.enable_compile_cache() == want
        assert updates["jax_compilation_cache_dir"] == want
    assert updates["jax_persistent_cache_min_compile_time_secs"] \
        == cache.MIN_COMPILE_SECONDS


def test_pinned_precision_against_float64():
    """The tone-power products and bit probes at a 60 s shape, in
    float32 at the pinned precision, against float64 numpy."""
    from axctdprocessor_tpu.models import simulator
    from axctdprocessor_tpu.ops import goertzel

    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=60.0, seed=5))
    x = ((pcm - pcm.mean()) / np.abs(pcm).max()).astype(np.float32)
    err = chip_smoke.numerics_errors(x, 44100.0, goertzel.PRECISION,
                                     np.arange(0, len(x) - 64, 97))
    assert max(err.values()) <= goertzel.POWER_RTOL, err


def _package_sources():
    return sorted((REPO / "axctdprocessor_tpu").rglob("*.py"))


def test_no_tpu_code_in_package():
    """No module imports the TPU Pallas dialect or compares a backend
    with "tpu"."""
    bad = []
    for path in _package_sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", None) or ""
                names = [mod] + [f"{mod}.{a.name}".strip(".")
                                 for a in node.names]
                if any(n.startswith("jax.experimental.pallas.tpu")
                       or n.endswith("pallas.tpu") for n in names):
                    bad.append(f"{path}:{node.lineno} imports pallas.tpu")
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
                consts = [c.value for c in sides if isinstance(c, ast.Constant)]
                other = " ".join(ast.unparse(c) for c in sides)
                if "tpu" in consts and ("backend" in other
                                        or "platform" in other):
                    bad.append(f"{path}:{node.lineno} compares a backend "
                               f"with 'tpu'")
    assert not bad, bad
