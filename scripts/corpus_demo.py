#!/usr/bin/env python3
"""Archive corpus demonstration (BASELINE config 5, single-host form).

Generates N synthetic 60 s drops as int16 WAVs, then runs the archive
reprocessor (length-bucketed batches, int8 wire, threaded read-ahead,
manifest checkpointing) on the attached chip and reports aggregate
throughput.  Usage: corpus_demo.py [n_drops] [batch_size]
"""

import os
import sys
import time

import numpy as np

N_DROPS = int(sys.argv[1]) if len(sys.argv) > 1 else 100
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 8
DUR = 60.0
CORPUS = "/tmp/axctd_corpus"
OUT = "/tmp/axctd_corpus_out"


def build_corpus():
    from axctdprocessor_tpu.models import simulator

    os.makedirs(CORPUS, exist_ok=True)
    paths = []
    base = None
    for k in range(N_DROPS):
        path = os.path.join(CORPUS, f"drop{k:04d}.wav")
        paths.append(path)
        if os.path.exists(path):
            continue
        if base is None:
            spec = simulator.SimSpec(duration=DUR, profile_start=40.0,
                                     seed=21)
            pcm, _ = simulator.synthesize(spec)
            base = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(
                np.int16)
        rng = np.random.default_rng(1000 + k)
        row = np.clip(base.astype(np.int32)
                      + rng.integers(-300, 300, len(base)),
                      -32768, 32767).astype(np.int16)
        simulator.write_wav(path, row / 32768.0, 44100)
    return paths


def main():
    import jax

    print("backend:", jax.default_backend())
    t0 = time.perf_counter()
    paths = build_corpus()
    print(f"corpus: {len(paths)} x {DUR:.0f}s drops "
          f"({time.perf_counter()-t0:.1f}s to generate)")

    from axctdprocessor_tpu.parallel.archive import reprocess_corpus
    import shutil

    shutil.rmtree(OUT, ignore_errors=True)
    # warm pass on a small slice compiles the batch programs
    reprocess_corpus(paths[:BATCH], OUT, batch_size=BATCH, resume=False)

    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, OUT, batch_size=BATCH, resume=False)
    wall = time.perf_counter() - t0

    done = sum(1 for v in manifest["files"].values()
               if v.get("status") == "done")
    failed = [k for k, v in manifest["files"].items()
              if v.get("status") != "done"]
    audio = done * DUR
    print(f"decoded {done}/{len(paths)} drops in {wall:.1f} s "
          f"-> {audio/wall:.0f}x realtime aggregate")
    if failed:
        print("failed:", failed[:5])
    rpt = os.path.join(OUT, "drop0000.txt")
    with open(rpt) as fh:
        head = fh.read().splitlines()
    assert any("Probe Serial: 00123456" in ln for ln in head), head[:12]
    print("report spot-check OK:", rpt)


if __name__ == "__main__":
    main()
