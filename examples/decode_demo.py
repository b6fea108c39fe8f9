#!/usr/bin/env python3
"""End-to-end demo: synthesize an AXCTD drop, decode it three ways.

Run from the repo root:  python examples/decode_demo.py
(On a machine without a GPU, set JAX_PLATFORMS=cpu.)
"""

import numpy as np

from axctdprocessor_tpu.models import simulator
from axctdprocessor_tpu.models.parity_engine import decode_wav
from axctdprocessor_tpu.models.stream import AXCTDStreamDecoder
from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu


def main():
    # 1. synthesize a 45 s drop and write it as a WAV file
    spec = simulator.SimSpec(duration=45.0, profile_start=33.0, seed=7)
    pcm, truth = simulator.synthesize(spec)
    simulator.write_wav("demo_drop.wav", pcm, spec.fs)
    print(f"synthesized demo_drop.wav (serial {truth['serial_no']})")

    # 2. byte-parity engine (identical to the upstream implementation)
    res = decode_wav("demo_drop.wav")
    print(f"parity engine : {len(res.time)} rows, "
          f"serial {res.metadata['serial_no']}, "
          f"T {res.temperature[0]:.2f} -> {res.temperature[-1]:.2f} C")

    # 3. fused device engine
    res = decode_wav_tpu("demo_drop.wav")
    print(f"fused engine  : {len(res.time)} rows, "
          f"S {res.salinity[0]:.2f} -> {res.salinity[-1]:.2f} PSU")

    # 4. realtime streaming (0.5 s radio blocks)
    dec = AXCTDStreamDecoder(spec.fs)
    block = int(0.5 * spec.fs)
    live_rows = 0
    for pos in range(0, len(pcm), block):
        dec.feed(pcm[pos:pos + block])
        live_rows += len(dec.latest_rows())
    dec.finalize()
    live_rows += len(dec.latest_rows())
    print(f"streaming     : {live_rows} rows emitted incrementally, "
          f"status {dec.status}")


if __name__ == "__main__":
    main()
