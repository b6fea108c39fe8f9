#!/usr/bin/env python3
"""Live-receiver latency of the device streaming decoder.

Measures, on the accelerator, what a realtime embedder cares about:

* ``prewarm_s``      — TPUStreamDecoder(fs, max_duration=...) wall: the
                       one-time cost paid BEFORE the drop (segment +
                       pinned assemble compiles, first-D2H warmup);
* ``ttfr_s``         — time to first profile rows: from pushing the
                       feed block that completes the first
                       profile-bearing segment to a ``results()``
                       snapshot returning rows (upload + segment
                       dispatch + pinned assemble + fetch);
* ``snapshot_s``     — steady-state ``results()`` latency mid-stream;
* ``finalize_s``     — tail flush + final assemble at end of stream.

The stream is the bench drop's first 180 s fed in 2 s receiver blocks.
Writes bench_artifacts/stream_ttfr.json.

Replaces the reference's realtime loop (AXCTDprocessor.py:119,283,338 —
per-chunk host demod with sleep-yield), whose per-chunk latency IS its
chunk time; here the segment program + pinned assemble run async on the
device and a snapshot is one assemble dispatch.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _artifact import record
from axctdprocessor_tpu.models import simulator
from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

FS = 44100
DURATION = 180.0
MAX_DURATION = 660.0  # pin for a full ~10-min drop + margin
BLOCK_S = 2.0


def main():
    import jax

    spec = simulator.SimSpec(duration=DURATION, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)

    t0 = time.perf_counter()
    dec = TPUStreamDecoder(FS, max_duration=MAX_DURATION)
    prewarm_s = time.perf_counter() - t0

    step = int(BLOCK_S * FS)
    ttfr_s = None
    first_rows_at_audio_s = None
    snapshot_times = []
    last_k = 0
    for i in range(0, len(x), step):
        k = dec.feed(x[i:i + step])
        if k == last_k:
            continue
        last_k = k
        t0 = time.perf_counter()
        snap = dec.results()
        dt = time.perf_counter() - t0
        if len(snap.time) and ttfr_s is None:
            ttfr_s = dt  # the snapshot that surfaced the first rows
            first_rows_at_audio_s = (i + step) / FS
        elif ttfr_s is not None:
            snapshot_times.append(dt)

    t0 = time.perf_counter()
    res = dec.finalize()
    finalize_s = time.perf_counter() - t0
    assert res.status == 2 and res.metadata["serial_no"] == truth["serial_no"]

    out = {
        "backend": jax.default_backend(),
        "pin_bucket": int(dec._pin_bucket),
        "max_duration_s": MAX_DURATION,
        "stream_s": DURATION,
        "block_s": BLOCK_S,
        "prewarm_s": round(prewarm_s, 3),
        "ttfr_s": round(ttfr_s, 3) if ttfr_s is not None else None,
        "first_rows_at_audio_s": first_rows_at_audio_s,
        "snapshot_s_median": (round(float(np.median(snapshot_times)), 3)
                              if snapshot_times else None),
        "snapshot_s_max": (round(float(np.max(snapshot_times)), 3)
                           if snapshot_times else None),
        "n_snapshots": len(snapshot_times),
        "finalize_s": round(finalize_s, 3),
        "rows_final": len(res.time),
    }
    print(out)
    record("stream_ttfr", out)


if __name__ == "__main__":
    main()
