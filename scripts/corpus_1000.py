#!/usr/bin/env python3
"""The BASELINE archive config at spec scale: a 1000-drop corpus run.

BASELINE.md:27 commits to "1000-drop corpus" reprocessing; bench.py
measures a 64-drop scale unit per run.  This script runs the real thing
once, end to end on the accelerator, and records the artifact: manifest
growth, quarantine behavior, read-ahead threading and sustained corpus
throughput at a scale 64 drops never exercises.

Corpus: 1000 WAVs of mixed duration (45/60/90/120 s) and rate (44.1 kHz
plus an 88.2 kHz slice exercising on-device decimation), independent
noise per file, plus 5 deliberately corrupt files that the runner must
QUARANTINE (manifest status "failed") without aborting the job.

Writes bench_artifacts/corpus_1000.json.  Replaces the reference's
serial per-file loop (AXCTDprocessor.py:267-338) scaled out.
"""

import glob
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from _artifact import record

N_FILES = int(os.environ.get("CORPUS_N", "1000"))  # override to smoke-test
CORPUS_DIR = f"/tmp/corpus{N_FILES}"
OUT_DIR = f"/tmp/corpus{N_FILES}_out"
N_CORRUPT = 5
SPECS = [  # (duration_s, fs, weight)
    (60.0, 44100, 0.55),
    (45.0, 44100, 0.15),
    (90.0, 44100, 0.15),
    (120.0, 44100, 0.10),
    (60.0, 88200, 0.05),  # >50 kHz: on-device decimate-by-2 path
]


def build_corpus() -> None:
    from scipy.io import wavfile

    from axctdprocessor_tpu.models import simulator

    os.makedirs(CORPUS_DIR, exist_ok=True)
    rng = np.random.default_rng(1000)
    bases = {}
    for dur, fs, _ in SPECS:
        spec = simulator.SimSpec(duration=dur, fs=fs,
                                 profile_start=min(33.0, dur * 0.4), seed=5)
        pcm, _ = simulator.synthesize(spec)
        scale = 28000 / np.max(np.abs(pcm))
        bases[(dur, fs)] = np.round(pcm * scale).astype(np.int16)

    keys = [(d, f) for d, f, _ in SPECS]
    weights = np.asarray([w for _, _, w in SPECS])
    choice = rng.choice(len(keys), N_FILES - N_CORRUPT,
                        p=weights / weights.sum())
    t0 = time.perf_counter()
    for i, ki in enumerate(choice):
        dur, fs = keys[ki]
        base = bases[(dur, fs)]
        noisy = np.clip(base + rng.integers(-300, 300, len(base)),
                        -32768, 32767).astype(np.int16)
        wavfile.write(os.path.join(CORPUS_DIR, f"drop{i:04d}.wav"),
                      fs, noisy)
    # the quarantine set: must be isolated, never abort the job
    open(os.path.join(CORPUS_DIR, "bad_empty.wav"), "wb").close()
    with open(os.path.join(CORPUS_DIR, "bad_truncated.wav"), "wb") as f:
        f.write(b"RIFF\x24\x00\x00\x00WAVE")  # header only, no fmt/data
    with open(os.path.join(CORPUS_DIR, "bad_random.wav"), "wb") as f:
        f.write(rng.integers(0, 256, 4096, np.uint8).tobytes())
    with open(os.path.join(CORPUS_DIR, "bad_text.wav"), "w") as f:
        f.write("this is not audio\n" * 64)
    with open(os.path.join(CORPUS_DIR, "bad_cut_data.wav"), "wb") as f:
        # valid header claiming more data than present
        buf = bases[(60.0, 44100)][: 44100].tobytes()
        wavfile.write(f, 44100, bases[(60.0, 44100)][: 2 * 44100])
        f.truncate(44 + len(buf) // 2)
    print(f"built {N_FILES}-file corpus in "
          f"{time.perf_counter() - t0:.1f} s")


def main():
    from axctdprocessor_tpu.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu.utils.profiling import StageTimer

    if len(glob.glob(os.path.join(CORPUS_DIR, "*.wav"))) != N_FILES:
        shutil.rmtree(CORPUS_DIR, ignore_errors=True)
        build_corpus()
    paths = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.wav")))
    assert len(paths) == N_FILES

    from scipy.io import wavfile as _w

    durs = {}
    for p in paths:
        name = os.path.basename(p)
        if not name.startswith("drop"):
            continue
        nbytes = os.path.getsize(p) - 44
        # read fs from the header (cheap, mmap)
        fs = int(_w.read(p, mmap=True)[0])
        durs[name] = nbytes / 2 / fs
    audio_s = float(sum(durs.values()))

    # resume from an existing manifest by default: an interrupted run
    # picks up where it stopped, and redoing finished files would
    # conflate the interruption with decode wall.  corpus_rtf is
    # computed over the audio decoded THIS run only.
    prev_done = set()
    man_path = os.path.join(OUT_DIR, "manifest.json")
    if os.environ.get("CORPUS_FRESH") == "1":
        shutil.rmtree(OUT_DIR, ignore_errors=True)
    elif os.path.exists(man_path):
        with open(man_path) as f:
            prev = json.load(f)
        # 'done' ONLY: reprocess_corpus(resume=True) re-decodes previously
        # FAILED files, so their audio must count toward this run's
        # corpus_rtf denominator (ADVICE r4: counting them as skipped
        # biased corpus_rtf low and overstated resumed_from)
        prev_done = {n for n, v in prev.get("files", {}).items()
                     if v["status"] == "done"}
        print(f"resuming: {len(prev_done)} files already done")

    timer = StageTimer()
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, OUT_DIR, batch_size=8,
                                resume=bool(prev_done), timer=timer)
    wall = time.perf_counter() - t0

    statuses = [v["status"] for v in manifest["files"].values()]
    done = statuses.count("done")
    failed = statuses.count("failed")
    rows = sum(v.get("rows", 0) for v in manifest["files"].values()
               if v["status"] == "done")
    reports = len(glob.glob(os.path.join(OUT_DIR, "*.txt")))
    decoded_s = sum(durs[n] for n, v in manifest["files"].items()
                    if v["status"] == "done")
    decoded_s_run = sum(durs[n] for n, v in manifest["files"].items()
                        if v["status"] == "done" and n not in prev_done)

    out = {
        "n_files": N_FILES,
        "done": done,
        "quarantined": failed,
        "accounted": done + failed,
        "reports_written": reports,
        "profile_rows": rows,
        "audio_s_total": round(audio_s, 1),
        "audio_s_decoded": round(decoded_s, 1),
        "audio_s_decoded_this_run": round(decoded_s_run, 1),
        "resumed_from": len(prev_done),
        "wall_s": round(wall, 1),
        "corpus_rtf": round(decoded_s_run / max(wall, 1e-9), 1),
        "stage_times": timer.as_dict(),
        "quarantine_entries": {
            n: v for n, v in manifest["files"].items()
            if v["status"] == "failed"},
    }
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("stage_times", "quarantine_entries")}))
    assert done + failed == N_FILES, "every file must be accounted for"
    assert failed == N_CORRUPT, f"expected {N_CORRUPT} quarantined, {failed}"
    assert done == N_FILES - N_CORRUPT
    record(f"corpus_{N_FILES}", out)


if __name__ == "__main__":
    main()
