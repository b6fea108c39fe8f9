"""Persist microbench results as checked-in JSON artifacts.

Every scripts/microbench_* records its measured numbers into
``bench_artifacts/<name>.json`` next to its stdout report, so perf
claims are reproducible from committed files instead of living only in
prose.  Importing this module also places the persistent compile cache
(utils.cache), which every script imports first.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from axctdprocessor_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

ART_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bench_artifacts")


def record(name: str, payload: dict) -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    payload = dict(payload)
    payload.setdefault("bench", name)
    payload.setdefault("recorded_at",
                       time.strftime("%Y-%m-%dT%H:%M:%S%z"))
    try:
        import jax

        payload.setdefault("backend", jax.default_backend())
    except Exception:
        pass
    path = os.path.join(ART_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {path}")
    return path


class _Tee:
    def __init__(self, orig):
        self.orig = orig
        self.buf = ""

    def write(self, s):
        self.orig.write(s)
        self.buf += s

    def flush(self):
        self.orig.flush()


def record_report(name: str, main_fn) -> None:
    """Run a microbench main() and persist everything it printed as the
    artifact's ``report`` lines (still echoed live)."""
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        main_fn()
    finally:
        sys.stdout = tee.orig
    record(name, {"report": tee.buf.strip().splitlines()})


def record_runs(name: str, main_fn) -> None:
    """Like record_report, but ACCUMULATES: each invocation (one mode
    per process) appends its printed report to the artifact's ``runs``
    list, so the committed file captures every configuration tried —
    including the ones that lost."""
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        main_fn()
    finally:
        sys.stdout = tee.orig
    path = os.path.join(ART_DIR, f"{name}.json")
    runs = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            runs = prev.get("runs", [])
        except Exception:
            runs = []
    runs.append({"recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                 "report": tee.buf.strip().splitlines()})
    record(name, {"runs": runs})
