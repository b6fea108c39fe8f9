#!/usr/bin/env python3
"""Pipeline-depth sweep for the device-resident decode's sustained
throughput: K back-to-back dispatches with all fetches after the last
dispatch (the steady state of a corpus job over resident drops).  The
bench's resident child uses K=4; if deeper pipelining keeps hiding the
result-fetch + dispatch-queueing overhead, per-decode wall approaches
pure device compute.  Programs are the shipped public API's (cached).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import jax

from axctdprocessor_tpu.models import segmented, simulator
from _artifact import record

FS = 44100.0
WAV_SECONDS = 600.0


def main():
    ks = [int(a) for a in sys.argv[1:]] or [4, 8, 12]
    print("backend:", jax.default_backend())
    spec = simulator.SimSpec(duration=WAV_SECONDS, profile_start=33.0,
                             seed=11)
    pcm, _ = simulator.synthesize(spec)
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    st = segmented.prestage_waveform(raw, FS, wire="int8")
    res = st.decode()  # warmup
    print("decode:", res.status, len(res.hexframes), "frames")
    out = {"mode": "ksweep", "wav_seconds": WAV_SECONDS}
    for k in ks:
        best = 1e9
        for _ in range(4):
            t0 = time.perf_counter()
            outs = [st.dispatch() for _ in range(k)]
            for o in outs:
                jax.device_get(o)
            best = min(best, (time.perf_counter() - t0) / k)
        print(f"K={k:2d}: {best * 1e3:.1f} ms/drop "
              f"-> {WAV_SECONDS / best:.0f}x realtime")
        out[f"tput_ms_k{k}"] = round(best * 1e3, 2)
    record("resident_ksweep", out)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
