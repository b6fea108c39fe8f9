#!/usr/bin/env python3
"""Mechanism isolation for the int4-ns batch-row failures: decode one
failing row with (a) noise-shaped int4 (C encoder), (b) plain-rounded
int4 (numpy fallback), (c) int8, and (d) noise-shaped int4 on the SAME
row without its added noise.  Run on the CPU from the repository root:
    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/diagnose_int4_row.py [ROW]
"""

import sys

import numpy as np

from axctdprocessor_tpu.models import simulator
from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu
from axctdprocessor_tpu.ops import wire as wire_ops
from axctdprocessor_tpu.utils import native

BATCH_SECONDS = 60.0
ROW = int(sys.argv[1]) if len(sys.argv) > 1 else 2


def main():
    rng = np.random.default_rng(7)
    spec = simulator.SimSpec(duration=BATCH_SECONDS, profile_start=40.0,
                             seed=21)
    pcm, truth = simulator.synthesize(spec)
    base = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    rows = [np.clip(base + rng.integers(-300, 300, len(base)),
                    -32768, 32767).astype(np.int16) for _ in range(ROW + 1)]
    row = rows[ROW]

    def report(tag, res):
        print(f"{tag:18s} status={res.status} "
              f"serial={res.metadata.get('serial_no')!r} "
              f"frames={len(res.hexframes)} rows={len(res.time)}")

    report("int4-ns", decode_waveform_tpu(row, 44100, wire="int4"))

    lib = native._LIB if hasattr(native, "_LIB") else None
    # force the numpy plain-rounding path by hiding the C library
    get_lib = native.get_library
    native.get_library = lambda: None
    orig = native.quantize_int4_ns_native
    native.quantize_int4_ns_native = lambda pcm: None
    try:
        report("int4-plain", decode_waveform_tpu(row, 44100, wire="int4"))
    finally:
        native.quantize_int4_ns_native = orig
        native.get_library = get_lib

    report("int8", decode_waveform_tpu(row, 44100, wire="int8"))
    report("int4-ns no-noise", decode_waveform_tpu(base, 44100, wire="int4"))
    print("truth serial:", truth["serial_no"])


if __name__ == "__main__":
    main()
