#!/usr/bin/env python3
"""Wall-clock attribution for the single-file segmented decode.

Runs the 600 s bench drop through decode_waveform_segmented with the
StageTimer enabled and prints per-stage walls for warm repeats: host
encode/stats, dispatch loop (chunk encode + build/upload enqueue),
assemble dispatch, result fetch (residual device compute + D2H), host
finish.  Usage: run on the accelerator, one process per configuration.
"""

import os
import time

import numpy as np
import jax

from axctdprocessor_tpu.models import segmented, simulator
from axctdprocessor_tpu.utils.profiling import StageTimer
from axctdprocessor_tpu.utils.wavio import read_wav_raw16

WAV = "/tmp/bench_drop600.wav"


def main():
    print("backend:", jax.default_backend())
    if not os.path.exists(WAV):
        spec = simulator.SimSpec(duration=600.0, profile_start=33.0, seed=11)
        pcm, _ = simulator.synthesize(spec)
        simulator.write_wav(WAV, pcm, spec.fs)
    raw, fs = read_wav_raw16(WAV)

    res = segmented.decode_waveform_segmented(raw, fs, wire="auto")
    print("warm:", res.status, len(res.hexframes), "frames, wire", res.wire)

    for rep in range(3):
        t = StageTimer()
        t0 = time.perf_counter()
        segmented.decode_waveform_segmented(raw, fs, wire="auto", timer=t)
        wall = time.perf_counter() - t0
        print(f"--- repeat {rep}: wall {wall*1e3:.0f} ms ---")
        print(t.report())


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("walltrace", main)
