#!/usr/bin/env python3
"""Benchmark: full AXCTD decode throughput on one GPU.

Primary metric: realtime factor — seconds of 44.1 kHz AXCTD audio fully
decoded (WAV-conditioned PCM -> QC'd T/C/S/z profile + header metadata)
per second of wall clock, for the segmented fused engine on a 600 s
drop over the default wire ("auto" = int16).  Extra fields report the
device-resident decode (prestaged device buffers), the int8 wire, the
batched 64-drop pipelined decode, and the 64-WAV archive-runner corpus
throughput.

Each metric runs in its OWN child process, one at a time, and this
parent never starts a JAX backend: a process that uses the card
reserves most of its memory, so only one process may hold it.  Every
child uses the persistent compile cache (utils.cache), so a metric's
compiles are paid once per cache.

The bench refuses to run without a GPU: ``main()`` asks a child for the
device first and exits non-zero, having timed nothing, if it is not a
GPU.

The bench treats its own output as a product with an SLO:

* a GLOBAL DEADLINE (AXCTD_BENCH_DEADLINE_S, default 1800 s) is checked
  before every child; children that no longer fit are SKIPPED and the
  line still prints with whatever was measured;
* metrics run HEADLINE-FIRST (single_auto, then resident, then the
  secondary children) so an early kill still records the number that
  matters;
* after every child the current partial JSON is flushed to stderr
  (``# partial {...}``), and SIGTERM/SIGINT print the final line with
  whatever exists before exiting;
* every child prints its own one-line ``#CHILD {...}`` JSON to stderr
  as it finishes (even on assert failure) for post-mortem forensics.

``vs_baseline`` compares against the upstream implementation measured on
a host CPU (BASELINE_MEASURED.json: 22.66x realtime; the reference
publishes no benchmarks of its own — SURVEY.md 6).

Prints exactly one JSON line on stdout.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REFERENCE_RTF = 22.66  # see BASELINE_MEASURED.json
DURATION = 600.0
REPEATS = 3
BATCH_DROPS = 64       # BASELINE.md:26 — the spec batch config (64/chip)
BATCH_SUB = 8          # drops per pipelined sub-batch dispatch
BATCH_SECONDS = 60.0
CORPUS_DROPS = 64      # archive-runner measurement (BASELINE.md:27 scale unit)
WAV = os.path.join(tempfile.gettempdir(), "bench_drop600.wav")
PARITY_CACHE = os.path.join(tempfile.gettempdir(), "bench_drop600_parity.txt")
CORPUS_DIR = os.path.join(tempfile.gettempdir(), "bench_corpus64")

DEADLINE_S = float(os.environ.get("AXCTD_BENCH_DEADLINE_S", "1800"))
_T0 = time.monotonic()

# what the children record as they go; dumped to stderr on exit so a
# killed/asserted child still leaves its numbers behind
CHILD_REC: dict = {}

# the accumulating bench record; _emit() serializes it after every child
RESULT: dict = {}


def _remaining() -> float:
    return DEADLINE_S - (time.monotonic() - _T0)


def _write_drop():
    from axctdprocessor_tpu.models import simulator

    spec = simulator.SimSpec(duration=DURATION, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    simulator.write_wav(WAV, pcm, spec.fs)
    return truth


def _parity_frames() -> list[str]:
    """Hexframes of the byte-exact parity engine on the bench drop —
    the correctness reference the timed children compare against (a
    subtly-wrong decode must fail the gate, not post a headline).
    Cached: the WAV is deterministic (seed 11)."""
    if os.path.exists(PARITY_CACHE):
        frames = open(PARITY_CACHE).read().split()
        if len(frames) > 1000:
            return frames
    from axctdprocessor_tpu.models.parity_engine import decode_wav

    res = decode_wav(WAV)
    assert res.status == 2 and len(res.hexframes) > 1000, "parity ref failed"
    with open(PARITY_CACHE, "w") as f:
        f.write(" ".join(res.hexframes))
    return res.hexframes


def _truth_serial():
    return "00123456"  # simulator default serial (checked in children)


def _batch_rows():
    """The 64 x 60 s int16 batch: one simulated drop + independent noise
    per row (no cross-drop caching can help)."""
    from axctdprocessor_tpu.models import simulator

    return simulator.noisy_rows(BATCH_DROPS, simulator.SimSpec(
        duration=BATCH_SECONDS, profile_start=40.0, seed=21))


def child_single(wire: str) -> None:
    """Timed single-file decode in a fresh process; prints WALL seconds."""
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    t0 = time.perf_counter()
    res = decode_wav_tpu(WAV, wire=wire)  # warmup: compile + first D2H
    CHILD_REC["warmup_s"] = round(time.perf_counter() - t0, 3)
    assert res.status == 2 and len(res.time) > 1000, (
        f"warmup decode failed: status={res.status} rows={len(res.time)}")
    assert res.metadata["serial_no"] == _truth_serial()
    assert res.overflow == 0, f"clipped decode: overflow={res.overflow}"
    n_frames = len(res.hexframes)
    CHILD_REC["frames"] = n_frames
    # correctness gate vs the byte-exact parity engine (not just "many
    # frames": a symmetric frame-loss regression must fail here)
    parity = set(open(PARITY_CACHE).read().split())
    got = set(res.hexframes)
    agree = len(got & parity) / max(len(got | parity), 1)
    CHILD_REC["agree"] = round(agree, 4)
    floor = 0.99
    assert agree > floor, f"frame agreement vs parity {agree:.4f} < {floor}"

    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res = decode_wav_tpu(WAV, wire=wire)
        times.append(time.perf_counter() - t0)
        CHILD_REC["wall_s"] = round(min(times), 4)
    assert abs(len(res.hexframes) - n_frames) <= 0.01 * n_frames
    print(f"WALL {min(times):.6f} FRAMES {n_frames} WIRE {res.wire} "
          f"AGREE {agree:.4f}")


def child_resident() -> None:
    """Device-resident decode throughput through the PUBLIC prestaged
    API (segmented.prestage_waveform): every grouped segment buffer
    pre-staged in device memory, then time (grouped dispatches + chunked
    assemble + packed-result fetch) for the 600 s drop; prints WALL
    seconds plus the pipelined sustained-throughput TPUT."""
    import jax

    from axctdprocessor_tpu.models.segmented import prestage_waveform
    from axctdprocessor_tpu.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(WAV)
    t0 = time.perf_counter()
    st = prestage_waveform(raw, float(fs), wire="int8")
    CHILD_REC["prestage_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    res = st.decode()  # warmup (compile + first D2H)
    CHILD_REC["warmup_s"] = round(time.perf_counter() - t0, 3)
    assert res.status == 2 and res.metadata["serial_no"] == _truth_serial()
    parity = set(open(PARITY_CACHE).read().split())
    got = set(res.hexframes)
    agree = len(got & parity) / max(len(got | parity), 1)
    CHILD_REC["frames"] = len(res.hexframes)
    CHILD_REC["agree"] = round(agree, 4)
    assert agree > 0.99, f"resident decode agreement {agree:.4f}"

    times = []
    for _ in range(max(REPEATS, 4)):
        t0 = time.perf_counter()
        jax.device_get(st.dispatch())
        times.append(time.perf_counter() - t0)
        CHILD_REC["wall_s"] = round(min(times), 4)

    # sustained resident throughput: K back-to-back decodes with every
    # result fetched after the last dispatch, so decode i's result fetch
    # rides under decode i+1's device compute — the steady state of a
    # corpus/archive job with resident data (K not yet tuned on the GPU)
    K = 8
    tput = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        outs_k = [st.dispatch() for _ in range(K)]
        for o in outs_k:
            jax.device_get(o)
        tput = min(tput, (time.perf_counter() - t0) / K)
        CHILD_REC["tput_s"] = round(tput, 4)

    print(f"WALL {min(times):.6f} FRAMES {len(res.hexframes)} "
          f"AGREE {agree:.4f} TPUT {tput:.6f}")


def child_batch() -> None:
    """Timed 64 x 60 s pipelined batch decode; prints WALL seconds."""
    from axctdprocessor_tpu.parallel.pipeline import decode_batches_pipelined

    batch, truth = _batch_rows()
    lengths = [batch.shape[1]] * BATCH_SUB
    batches = [(batch[i:i + BATCH_SUB], lengths)
               for i in range(0, BATCH_DROPS, BATCH_SUB)]

    t0 = time.perf_counter()
    piped = decode_batches_pipelined(batches, 44100)  # warmup + compile
    CHILD_REC["warmup_s"] = round(time.perf_counter() - t0, 3)
    flat = [r for b in piped for r in b]
    ok = sum(r.status == 2 and r.metadata["serial_no"] == truth["serial_no"]
             for r in flat)
    assert ok == BATCH_DROPS, f"batch warmup: {ok}/{BATCH_DROPS} decoded"

    times = []
    for _ in range(max(REPEATS - 1, 2)):
        t0 = time.perf_counter()
        decode_batches_pipelined(batches, 44100)
        times.append(time.perf_counter() - t0)
        CHILD_REC["wall_s"] = round(min(times), 4)
    print(f"WALL {min(times):.6f} FRAMES {sum(len(r.hexframes) for r in flat)}")


def child_corpus() -> None:
    """Timed archive run: CORPUS_DROPS x 60 s WAVs from disk through the
    corpus runner (reads + batched decode + reports + manifest); prints
    WALL seconds.  This is the BASELINE archive config measured end to
    end at a 64-drop scale unit."""
    import glob
    import shutil

    from axctdprocessor_tpu.parallel.archive import reprocess_corpus

    if len(glob.glob(os.path.join(CORPUS_DIR, "*.wav"))) != CORPUS_DROPS:
        shutil.rmtree(CORPUS_DIR, ignore_errors=True)
        os.makedirs(CORPUS_DIR, exist_ok=True)
        from scipy.io import wavfile

        batch, _ = _batch_rows()
        for i in range(CORPUS_DROPS):
            wavfile.write(os.path.join(CORPUS_DIR, f"drop{i:03d}.wav"),
                          44100, batch[i])
    paths = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.wav")))

    out = os.path.join(tempfile.gettempdir(), "bench_corpus_out")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, out, batch_size=BATCH_SUB,
                                resume=False)  # warmup + compile
    CHILD_REC["warmup_s"] = round(time.perf_counter() - t0, 3)
    done = sum(1 for v in manifest["files"].values() if v["status"] == "done")
    assert done == CORPUS_DROPS, f"corpus warmup: {done}/{CORPUS_DROPS}"

    times = []
    for _ in range(2):
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        reprocess_corpus(paths, out, batch_size=BATCH_SUB, resume=False)
        times.append(time.perf_counter() - t0)
        CHILD_REC["wall_s"] = round(min(times), 4)
    print(f"WALL {min(times):.6f} FRAMES {done}")


def _run_child(mode: str, timeout: float = 2400.0) -> dict:
    """Run one metric in a fresh interpreter; returns its ``WALL`` line
    as a dict of lower-cased KEY VALUE pairs (``wall``, ``frames`` and,
    where the child prints them, ``wire``, ``agree``, ``tput``).  A hung
    child raises RuntimeError like any other failure — never
    TimeoutExpired."""
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", mode],
            capture_output=True, text=True, timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"child {mode} hung (> {timeout:.0f} s)") from e
    for line in (proc.stderr or "").splitlines():
        if line.startswith("#CHILD "):
            print(line, file=sys.stderr, flush=True)  # forensic record
    for line in (proc.stdout or "").splitlines():
        if line.startswith("WALL "):
            toks = line.split()
            rec = {k.lower(): v for k, v in zip(toks[::2], toks[1::2])}
            return {k: v if k == "wire" else float(v) for k, v in rec.items()}
    raise RuntimeError(
        f"child {mode} rc={proc.returncode}: {proc.stderr[-2000:]}")


def _try_child(mode: str, attempts: int = 2, timeout: float = 2400.0,
               est_s: float = 240.0) -> dict:
    """The child's record, or {} when every attempt failed.  Respects
    the global deadline: a child that no longer fits is skipped
    (recorded in RESULT["skipped"]) instead of blowing the budget."""
    for i in range(attempts):
        left = _remaining()
        if left < est_s:
            print(f"# skipping {mode}: {left:.0f} s left < {est_s:.0f} s "
                  f"estimate", file=sys.stderr, flush=True)
            RESULT.setdefault("skipped", []).append(mode)
            return {}
        try:
            return _run_child(mode, timeout=max(min(timeout, left - 20), 60))
        except Exception as e:
            print(f"# child {mode} attempt {i + 1}/{attempts} failed: {e}",
                  file=sys.stderr, flush=True)
    return {}


def _device() -> dict:
    """The first JAX device as a child process sees it (this process
    starts no backend)."""
    proc = subprocess.run(
        [sys.executable, "-c", "import json, jax; d = jax.devices(); "
         "print(json.dumps({'platform': d[0].platform, "
         "'kind': d[0].device_kind, 'count': len(d)}))"],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"device probe failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _payload() -> dict:
    """The bench JSON from whatever RESULT currently holds."""
    r = RESULT
    wall = r.get("wall_auto")
    wall_int8 = r.get("wall_int8")
    # headline: the default-wire single-file decode; degrade to the int8
    # wire if the auto child never succeeded, so a partial failure still
    # records a real measured number instead of nothing.
    if wall is not None:
        rtf, headline_wire = DURATION / wall, r.get("wire_auto")
    elif wall_int8 is not None:
        rtf, headline_wire = DURATION / wall_int8, "int8"
        wall = wall_int8
    else:
        rtf, headline_wire = 0.0, None  # no single-file child succeeded
    wall_res, tput_res = r.get("wall_res"), r.get("tput_res")
    batch_wall, corpus_wall = r.get("batch_wall"), r.get("corpus_wall")
    out = {
        "metric": "decode_realtime_factor",
        "value": round(rtf, 1),
        "unit": "audio_sec/sec/chip",
        "vs_baseline": round(rtf / REFERENCE_RTF, 2),
        "single_wall_s": round(wall, 3) if wall else None,
        "wire_auto": headline_wire,
        "frame_agreement_auto": r.get("agree_auto"),
        "frame_agreement_int8": r.get("agree_int8"),
        "frame_agreement_resident": r.get("agree_res"),
        "int8_rtf": (round(DURATION / wall_int8, 1) if wall_int8 else None),
        "resident_rtf": (round(DURATION / wall_res, 1) if wall_res else None),
        "resident_tput_rtf": (round(DURATION / tput_res, 1)
                              if tput_res else None),
        "batch_rtf": (round(BATCH_DROPS * BATCH_SECONDS / batch_wall, 1)
                      if batch_wall else None),
        "batch_drops": BATCH_DROPS,
        "batch_wall_s": round(batch_wall, 3) if batch_wall else None,
        "corpus_rtf": (round(CORPUS_DROPS * BATCH_SECONDS / corpus_wall, 1)
                       if corpus_wall else None),
        "corpus_drops": CORPUS_DROPS,
        "device": r.get("device"),
    }
    if r.get("skipped"):
        out["skipped"] = r["skipped"]
    return out


_FINAL_PRINTED = False


def _emit(final: bool) -> None:
    """Flush the current record: partials go to stderr after every child
    (a killed run still leaves the numbers in the tail); the final line
    is the one stdout JSON line of record."""
    global _FINAL_PRINTED
    if final:
        if not _FINAL_PRINTED:
            _FINAL_PRINTED = True
            print(json.dumps(_payload()), flush=True)
    else:
        print("# partial " + json.dumps(_payload()), file=sys.stderr,
              flush=True)


def _terminate(signum, frame):  # pragma: no cover - exercised by driver
    RESULT.setdefault("skipped", []).append(f"signal{signum}")
    _emit(final=True)
    os._exit(0)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        from axctdprocessor_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()
        mode = sys.argv[2]
        CHILD_REC["mode"] = mode
        try:
            if mode == "single_auto":
                child_single("auto")
            elif mode == "single_int8":
                child_single("int8")
            elif mode == "resident":
                child_resident()
            elif mode == "batch":
                child_batch()
            elif mode == "corpus":
                child_corpus()
            else:
                raise SystemExit(f"unknown child mode {mode}")
        finally:
            # forensic one-liner: even a child that asserts mid-run
            # leaves whatever it measured in the parent's stderr
            print("#CHILD " + json.dumps(CHILD_REC), file=sys.stderr,
                  flush=True)
        return 0

    device = _device()
    if device["platform"] != "gpu":
        print(f"bench.py needs a GPU; the first JAX device is "
              f"{device['platform']!r}. Nothing was timed.", file=sys.stderr)
        return 1
    RESULT["device"] = device
    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    # host-side prep is numpy-only; all device work happens in the
    # timeout-bounded children, so the bench always prints its JSON line
    _write_drop()
    _parity_frames()  # correctness reference for the timed children

    # headline first, then the resident capability number, then the
    # secondary metrics — an early kill costs the least valuable child
    rec = _try_child("single_auto", attempts=2, est_s=240)
    RESULT["wall_auto"], RESULT["agree_auto"] = rec.get("wall"), rec.get("agree")
    RESULT["wire_auto"] = rec.get("wire")
    _emit(final=False)

    rec = _try_child("resident", est_s=240)
    RESULT["wall_res"], RESULT["agree_res"] = rec.get("wall"), rec.get("agree")
    RESULT["tput_res"] = rec.get("tput")
    _emit(final=False)

    rec = _try_child("single_int8", est_s=180)
    RESULT["wall_int8"], RESULT["agree_int8"] = rec.get("wall"), rec.get("agree")
    _emit(final=False)

    RESULT["batch_wall"] = _try_child("batch", attempts=2, est_s=240).get("wall")
    _emit(final=False)

    RESULT["corpus_wall"] = _try_child("corpus", est_s=240).get("wall")

    _emit(final=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
