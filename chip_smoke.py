#!/usr/bin/env python3
"""Bring-up check: the AXCTD decode, end to end, on the GPU.

    python chip_smoke.py               # one card: the eight phases below
    python chip_smoke.py --four-cards  # the sharded paths on four cards

Every phase drives a public entry point on simulated drops (made from
fixed seeds at 44.1 kHz unless stated) and checks the result against
the byte-exact host parity engine:

1. device: the first JAX device is a GPU (no CPU fallback);
2. segmented: a 600 s drop through ``cli.main(--engine tpu)``;
3. monolithic: a 120 s drop through ``decode_wav_tpu``'s one program;
4. high rate: a 60 s drop at 96 kHz (x2 decimation on device);
5. resident: ``prestage_waveform(...).decode()`` on the 600 s drop;
6. archive: eight 60 s WAVs through ``cli.main(--corpus)``;
7. stream: ``TPUStreamDecoder`` fed 2 s blocks of the 120 s drop,
   ``finalize()`` equal to the offline segmented decode;
8. numerics: the tone-power products and bit probes at the 600 s shape
   against float64 numpy, at the pinned precision and at ``DEFAULT``.

A decode passes with status 2, the simulator's serial, header metadata
equal to the parity engine's and frame agreement (Jaccard over hex
frames) above 0.99.  Each phase prints one line with its wall and
compile seconds; the last line is the JSON verdict, printed only when
every phase passed.  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

FS = 44100
SERIAL = "00123456"  # simulator default
AGREE_FLOOR = 0.99
CORPUS_DROPS = 8
DROPS = {"d600": dict(duration=600.0), "d120": dict(duration=120.0),
         "d96k": dict(fs=96000, duration=60.0)}

_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event: str, secs: float, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += secs


def contract_line(devices) -> str:
    """The verdict line: ``ok`` and the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_line() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return "; ".join(s.strip() for s in out.splitlines() if s.strip())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def jaccard(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def check_decode(res, ref, label: str) -> str:
    """Hold a decode to the parity engine's: status 2, serial, equal
    header metadata, frame agreement above AGREE_FLOOR."""
    agree = jaccard(res.hexframes, ref.hexframes)
    if res.status != 2 or res.metadata.get("serial_no") != SERIAL:
        raise AssertionError(f"{label}: status {res.status}, serial "
                             f"{res.metadata.get('serial_no')!r}")
    if res.metadata != ref.metadata:
        diff = sorted(k for k in set(res.metadata) | set(ref.metadata)
                      if res.metadata.get(k) != ref.metadata.get(k))
        raise AssertionError(f"{label}: metadata differs in {diff}")
    if agree <= AGREE_FLOOR:
        raise AssertionError(f"{label}: frame agreement {agree:.4f}")
    return (f"status=2 serial={SERIAL} frames={len(res.hexframes)} "
            f"ref_frames={len(ref.hexframes)} agree={agree:.4f}")


def _report_parts(path: str):
    """(header block, profile hex column) of an ``output.txt``."""
    text = open(path).read()
    head = text.split("AXCTD header information:\n", 1)[1]
    head = head.split("\nProcessor Settings:", 1)[0]
    rows = text.split("AXCTD Profile:\n", 1)[1].splitlines()[1:]
    return head, [r.split(",")[1].strip() for r in rows]


def numerics_errors(x, fs: float, precision, starts) -> dict:
    """Largest relative error of the tone-power products and bit probes
    on ``x`` against float64 numpy evaluations of the same sums (same
    float32 inputs), each error relative to its tone column's largest
    power."""
    import jax
    import jax.numpy as jnp

    from axctdprocessor_tpu.ops import goertzel
    from axctdprocessor_tpu.utils.config import DecoderConfig

    cfg = DecoderConfig()
    window, stride = int(fs / 10), int(round(fs / 25))
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) \
        - 2 * cfg.bit_inset
    ptrig = goertzel.tone_matrix(window, [400.0, 7500.0, cfg.dead_freq], fs,
                                 dtype=np.float32)
    btrig = goertzel.tone_matrix(npcm, [cfg.mark_freq, cfg.space_freq], fs,
                                 dtype=np.float32)
    x = np.asarray(x, np.float32)
    starts = np.asarray(starts, np.int32)
    powers, probes = jax.jit(lambda v, s: (
        goertzel.framed_tone_power_tiled(v, window, stride, ptrig,
                                         precision=precision),
        goertzel.tone_power_at(v, s, npcm, btrig, precision=precision),
    ))(jnp.asarray(x), jnp.asarray(starts))

    x64 = x.astype(np.float64)
    n_win = powers.shape[0]
    n_tiles = -(-len(x) // stride)
    tiles = np.zeros(n_tiles * stride)
    tiles[:len(x)] = x64
    tiles = tiles.reshape(n_tiles, stride)
    trig64 = np.zeros((-(-window // stride) * stride, ptrig.shape[1]))
    trig64[:window] = ptrig
    proj = np.zeros((n_win, ptrig.shape[1]))
    for j in range(trig64.shape[0] // stride):
        p_j = tiles @ trig64[j * stride:(j + 1) * stride]
        take = p_j[j:j + n_win]
        proj[:len(take)] += take
    ref_p = np.hypot(proj[:, 0::2], proj[:, 1::2])
    frames = x64[starts[:, None] + np.arange(npcm)]
    bproj = frames @ btrig.astype(np.float64)
    ref_b = np.hypot(bproj[:, 0::2], bproj[:, 1::2])

    def rel(got, ref):
        return float(np.max(np.abs(np.asarray(got, np.float64) - ref)
                            / np.max(np.abs(ref), axis=0)))

    return {"powers": rel(powers, ref_p), "probes": rel(probes, ref_b)}


# ---------------------------------------------------------------------------
# drops
# ---------------------------------------------------------------------------

class Drops:
    """Simulated inputs and their parity-engine references, made once."""

    def __init__(self, root: str):
        from axctdprocessor_tpu.models import simulator

        self.root = root
        self.sim = simulator
        self._parity: dict = {}
        self.pcm = {}
        for key, kw in DROPS.items():
            spec = simulator.SimSpec(profile_start=33.0, seed=11, **kw)
            pcm, _ = simulator.synthesize(spec)
            self.pcm[key] = pcm
            simulator.write_wav(self.wav(key), pcm, spec.fs)

    def wav(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.wav")

    def parity(self, key: str):
        if key not in self._parity:
            from axctdprocessor_tpu.models.parity_engine import decode_wav

            self._parity[key] = decode_wav(self.wav(key))
        return self._parity[key]

    def conditioned(self, key: str) -> np.ndarray:
        pcm = self.pcm[key]
        return ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)

    def raw16(self, key: str):
        from axctdprocessor_tpu.utils.wavio import read_wav_raw16

        return read_wav_raw16(self.wav(key), allow_highrate=True)

    def batch_rows(self) -> np.ndarray:
        """CORPUS_DROPS x 60 s int16 rows: the bench's batch rows."""
        return self.sim.noisy_rows(CORPUS_DROPS)[0]


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def phase_segmented(d: Drops) -> str:
    from axctdprocessor_tpu import cli
    from axctdprocessor_tpu.models import tpu_engine
    from axctdprocessor_tpu.utils.config import DecoderConfig
    from axctdprocessor_tpu.utils.report import format_report

    # keep the result the CLI writes: the report's hex column is cut to
    # the QC'd row count (an upstream quirk), so frames are compared on
    # the result itself
    seen = []
    decode = tpu_engine.decode_wav_tpu

    def keep(*args, **kw):
        seen.append(decode(*args, **kw))
        return seen[-1]

    tpu_engine.decode_wav_tpu = keep
    try:
        out = os.path.join(d.root, "d600.txt")
        rc = cli.main(["-i", d.wav("d600"), "-o", out, "--engine", "tpu",
                       "--quiet"])
    finally:
        tpu_engine.decode_wav_tpu = decode
    if rc != 0 or len(seen) != 1:
        raise AssertionError(f"cli.main returned {rc}, {len(seen)} decodes")
    ref = d.parity("d600")
    # the parity result's own report; the echoed settings come after
    # the header block and are not compared
    echo = {"triggerrange": [30.0, -1], "minR400": 2.0, "mindR7500": 1.5,
            "deadfreq": 3000.0, "pointsperloop": 100000}
    ref_path = os.path.join(d.root, "d600_parity.txt")
    with open(ref_path, "w") as f:
        f.write(format_report(ref, d.wav("d600"), [0, -1], echo,
                              DecoderConfig()))
    head, rows = _report_parts(out)
    ref_head, _ = _report_parts(ref_path)
    if head != ref_head:
        raise AssertionError(f"report header differs:\n{head}\n--- parity\n"
                             f"{ref_head}")
    if len(rows) < 1000:
        raise AssertionError(f"only {len(rows)} profile rows")
    return f"report rows={len(rows)} " + check_decode(seen[0], ref, "cli")


def phase_monolithic(d: Drops) -> str:
    from axctdprocessor_tpu.models import tpu_engine

    if 120.0 > tpu_engine.AUTO_SEGMENT_SECONDS:
        raise AssertionError("120 s no longer takes the monolithic path")
    return check_decode(tpu_engine.decode_wav_tpu(d.wav("d120")),
                        d.parity("d120"), "monolithic")


def phase_highrate(d: Drops) -> str:
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    res = decode_wav_tpu(d.wav("d96k"))
    if res.fs != 48000.0:
        raise AssertionError(f"decimated rate {res.fs!r}")
    return check_decode(res, d.parity("d96k"), "high rate")


def phase_resident(d: Drops) -> str:
    from axctdprocessor_tpu.models import segmented

    raw, fs = d.raw16("d600")
    staged = segmented.prestage_waveform(raw, float(fs))
    return check_decode(staged.decode(), d.parity("d600"), "resident")


def phase_archive(d: Drops) -> str:
    from scipy.io import wavfile

    from axctdprocessor_tpu import cli

    src = os.path.join(d.root, "corpus")
    out = os.path.join(d.root, "corpus_out")
    os.makedirs(src)
    for i, row in enumerate(d.batch_rows()):
        wavfile.write(os.path.join(src, f"drop{i:03d}.wav"), FS, row)
    rc = cli.main(["--corpus", src, "-o", out, "--quiet"])
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    with open(os.path.join(out, "manifest.json")) as f:
        files = json.load(f)["files"]
    ok = 0
    for name, entry in sorted(files.items()):
        if entry.get("status") != "done" or entry.get("decode_status") != 2:
            continue
        head, _ = _report_parts(entry["output"])
        ok += f"Probe Serial: {SERIAL}" in head
    if ok != CORPUS_DROPS:
        raise AssertionError(f"{ok}/{CORPUS_DROPS} drops done with serial "
                             f"{SERIAL}")
    rows = [files[k]["rows"] for k in sorted(files)]
    return f"done={ok}/{CORPUS_DROPS} rows={min(rows)}..{max(rows)}"


def phase_stream(d: Drops) -> str:
    from axctdprocessor_tpu.models import segmented
    from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

    x = d.conditioned("d120")
    offline = segmented.decode_waveform_segmented(x, FS)
    dec = TPUStreamDecoder(FS, max_duration=len(x) / FS)
    step = 2 * FS
    for i in range(0, len(x), step):
        dec.feed(x[i:i + step])
    res = dec.finalize()
    fields = ("status", "metadata", "hexframes", "time", "depth",
              "temperature", "conductivity", "salinity", "firstpulse400",
              "profstartind", "numpoints")
    diff = [f for f in fields if getattr(res, f) != getattr(offline, f)]
    if diff:
        raise AssertionError(
            f"finalize() differs from the offline decode in {diff} "
            f"(frame agreement {jaccard(res.hexframes, offline.hexframes):.4f})")
    if res.status != 2 or res.metadata["serial_no"] != SERIAL:
        raise AssertionError(f"stream status {res.status}")
    return (f"finalize()==offline status=2 serial={SERIAL} "
            f"frames={len(res.hexframes)} rows={len(res.time)}")


def phase_numerics(d: Drops) -> str:
    from jax import lax

    from axctdprocessor_tpu.ops import goertzel

    x = d.conditioned("d600")
    starts = np.arange(0, len(x) - 64, 97)
    pinned = numerics_errors(x, FS, goertzel.PRECISION, starts)
    default = numerics_errors(x, FS, lax.Precision.DEFAULT, starts)
    worst = max(pinned.values())
    line = (f"pinned={goertzel.PRECISION.name} powers={pinned['powers']:.3e} "
            f"probes={pinned['probes']:.3e}; DEFAULT "
            f"powers={default['powers']:.3e} probes={default['probes']:.3e}; "
            f"tolerance={goertzel.POWER_RTOL:.0e}")
    if worst > goertzel.POWER_RTOL:
        raise AssertionError(line)
    return line


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------

class FourCards:
    """The sharded paths and the one-card decodes they are held to."""

    def __init__(self, d: Drops):
        from axctdprocessor_tpu.parallel.batch import decode_batch

        self.d = d
        self.rows = d.batch_rows()
        self.one_card = decode_batch(self.rows, FS)

    def check_rows(self, got, label: str) -> str:
        for i, (r, ref) in enumerate(zip(got, self.one_card)):
            check_decode(r, ref, f"{label} row {i}")
        agree = min(jaccard(r.hexframes, ref.hexframes)
                    for r, ref in zip(got, self.one_card))
        return (f"{len(got)} rows vs one card: metadata equal, "
                f"min agree={agree:.4f}")


def phase_dp(c: FourCards) -> str:
    from axctdprocessor_tpu.parallel.batch import decode_batch
    from axctdprocessor_tpu.parallel.mesh import make_mesh

    got = decode_batch(c.rows, FS, mesh=make_mesh({"dp": 4}))
    return "dp4 " + c.check_rows(got, "dp4")


def phase_sp(c: FourCards) -> str:
    from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu
    from axctdprocessor_tpu.parallel.mesh import make_mesh
    from axctdprocessor_tpu.parallel.timeshard import decode_batch_timesharded

    raw, fs = c.d.raw16("d600")
    ref = decode_waveform_tpu(raw, fs)  # one card, segmented
    (got,) = decode_batch_timesharded(raw[None, :], fs,
                                      mesh=make_mesh({"dp": 1, "sp": 4}))
    return "sp4 600 s vs one card: " + check_decode(got, ref, "sp4")


def phase_pipeline(c: FourCards) -> str:
    import jax

    from axctdprocessor_tpu.parallel.pipeline import decode_batches_pipelined

    half = CORPUS_DROPS // 2
    piped = decode_batches_pipelined(
        [(c.rows[:half], None), (c.rows[half:], None)], FS,
        devices=jax.devices()[:2])
    return "cards 0->1 " + c.check_rows([r for b in piped for r in b],
                                        "pipeline")


# ---------------------------------------------------------------------------

ONE_CARD = [("segmented", phase_segmented), ("monolithic", phase_monolithic),
            ("high rate", phase_highrate), ("resident", phase_resident),
            ("archive", phase_archive), ("stream", phase_stream),
            ("numerics", phase_numerics)]
FOUR_CARD = [("dp4 batch", phase_dp), ("sp4 time-sharded", phase_sp),
             ("pipeline", phase_pipeline)]


def _run(label: str, fn, arg) -> bool:
    t0, c0 = time.perf_counter(), _compile_s[0]
    try:
        detail, ok = fn(arg), True
    except Exception:
        detail, ok = "FAILED", False
        traceback.print_exc()
    print(f"phase {label}: {'ok' if ok else 'FAIL'} "
          f"wall={time.perf_counter() - t0:.1f}s "
          f"compile={_compile_s[0] - c0:.1f}s {detail}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the dp, sp and pipeline paths on 4 cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"phase 1 device: FAIL first device is "
              f"{devices[0].platform!r}, not a GPU", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"phase 1 device: FAIL {need} GPUs needed, "
              f"{len(devices)} found", file=sys.stderr)
        return 1

    from axctdprocessor_tpu.utils import native
    from axctdprocessor_tpu.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    print(f"card: {card_line()}")
    print(f"phase 1 device: ok {devices[0].device_kind} x{len(devices)} "
          f"jax={jax.__version__} compile_cache={cache} native_wavio="
          f"{'built' if native.get_library() is not None else 'missing'}",
          flush=True)

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    ok = True
    try:
        t0 = time.perf_counter()
        drops = Drops(root)
        print(f"# drops written in {time.perf_counter() - t0:.1f}s",
              flush=True)
        if args.four_cards:
            t0, c0 = time.perf_counter(), _compile_s[0]
            cards = FourCards(drops)
            print(f"# one-card batch reference in "
                  f"{time.perf_counter() - t0:.1f}s "
                  f"(compile {_compile_s[0] - c0:.1f}s)", flush=True)
            for label, fn in FOUR_CARD:
                ok &= _run(label, fn, cards)
        else:
            for i, (label, fn) in enumerate(ONE_CARD, start=2):
                ok &= _run(f"{i} {label}", fn, drops)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not ok:
        return 1
    print(contract_line(jax.devices()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
