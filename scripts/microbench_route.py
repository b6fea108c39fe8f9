#!/usr/bin/env python3
"""Fresh-process A/B: monolithic vs segmented for short files.

Usage: microbench_route.py <duration_s> <mode>   (child)
       microbench_route.py                        (parent: sweep)

Decides where the auto-routing threshold (AUTO_SEGMENT_SECONDS) should
sit now that segments are ~24 s and per-dispatch cost is small.
"""

import os
import subprocess
import sys
import time


def child(duration: float, mode: str) -> None:
    import numpy as np

    from axctdprocessor_tpu.models import simulator
    from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu

    spec = simulator.SimSpec(duration=duration, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    res = decode_waveform_tpu(raw, 44100, mode=mode, wire="int8")
    assert res.status == 2, res.status
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        decode_waveform_tpu(raw, 44100, mode=mode, wire="int8")
        best = min(best, time.perf_counter() - t0)
    print(f"WALL {best:.4f} frames={len(res.hexframes)}")


def main():
    if len(sys.argv) == 3:
        child(float(sys.argv[1]), sys.argv[2])
        return
    for dur in (60.0, 120.0, 240.0):
        for mode in ("monolithic", "segmented"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), str(dur), mode],
                capture_output=True, text=True, timeout=2400)
            line = next((ln for ln in proc.stdout.splitlines()
                         if ln.startswith("WALL")), f"rc={proc.returncode}")
            print(f"{dur:6.0f} s {mode:11s}: {line}")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("route", main)
