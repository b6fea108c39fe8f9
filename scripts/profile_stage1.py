#!/usr/bin/env python3
"""Stage-1 device time on the GPU, and the tone-power chain's share of it.

    python scripts/profile_stage1.py [OUT_DIR [DROP_S BATCH_S]]

OUT_DIR defaults to profile_out/stage1; DROP_S and BATCH_S (600 and 60)
shrink the drops for a rehearsal on the CPU.

Two workloads, each at the shape a user sends:

* batch: the monolithic batch program (``parallel.batch``) over the
  archive shape, 8 x 60 s int16 rows at 44.1 kHz;
* segmented: one 600 s drop through ``decode_waveform_segmented``.

For each, a ``jax.profiler`` trace of a few warm decodes is reduced to
device time per HLO module and per named scope, using the optimized HLO
that XLA dumps (kept gzipped in OUT_DIR, with the trace if it is small;
the scopes are ``stage1`` and
``tone_power``; the segmented path's stage 1 is its grouped segment
program).  Beside the trace, each piece is also timed alone on the host
clock (median of warm calls ending in ``block_until_ready``): the whole
stage 1, the tone-power chain (tiled DFT, smoothing, log10) and the tone
products at ``HIGHEST`` and at ``DEFAULT`` precision.

Runs without the persistent compile cache, so that every program
compiles and its HLO is dumped.
"""

import collections
import glob
import gzip
import json
import os
import re
import shutil
import sys
import tempfile
import time

OUT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                      else os.path.join("profile_out", "stage1"))
DROP_S, BATCH_S = (float(a) for a in (sys.argv[2:4] or (600, 60)))
WORK = tempfile.mkdtemp(prefix="profile_stage1_")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_dump_to="
    + os.path.join(WORK, "hlo") + " --xla_dump_hlo_as_text"
    + " --xla_dump_hlo_module_re=jit_(decode|segment|assemble)").strip()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from axctdprocessor_tpu.models import segmented, simulator  # noqa: E402
from axctdprocessor_tpu.models import tpu_engine as eng  # noqa: E402
from axctdprocessor_tpu.ops import goertzel, iir  # noqa: E402
from axctdprocessor_tpu.parallel import batch, pipeline  # noqa: E402
from axctdprocessor_tpu.utils.config import DecoderConfig  # noqa: E402
from axctdprocessor_tpu.utils.profiling import StageTimer  # noqa: E402

FS = 44100.0
CFG = DecoderConfig()


def median_ms(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def tone_chain(x, ptrig, n_power, d_pcm):
    p = goertzel.framed_tone_power_tiled(x, n_power, d_pcm, ptrig)
    sm = [iir.boxsmooth_lag(p[:, i], 5) for i in range(3)]
    return jnp.log10(sm[0] / sm[2]), jnp.log10(sm[1] / sm[2])


def products(x, starts, ptrig, btrig, n_power, d_pcm, npcm, precision):
    return (goertzel.framed_tone_power_tiled(x, n_power, d_pcm, ptrig,
                                             precision=precision),
            goertzel.tone_power_at(x, starts, npcm, btrig,
                                   precision=precision))


def alone(label, x, starts, ptrig, btrig, n_power, d_pcm, npcm, stage1_ms):
    """Host-clock times of the tone chain and the products, vmapped over
    the rows of ``x``, beside the stage-1 time."""
    chain = jax.jit(jax.vmap(lambda r: tone_chain(r, ptrig, n_power, d_pcm)))
    out = {"stage1_ms": stage1_ms, "tone_chain_ms": median_ms(chain, x)}
    for prec in (lax.Precision.HIGHEST, lax.Precision.DEFAULT):
        f = jax.jit(jax.vmap(lambda r, p=prec: products(
            r, starts, ptrig, btrig, n_power, d_pcm, npcm, p)))
        out[f"products_{prec.name}_ms"] = median_ms(f, x)
    out["tone_chain_share"] = out["tone_chain_ms"] / stage1_ms
    out["highest_minus_default_share"] = (
        out["products_HIGHEST_ms"] - out["products_DEFAULT_ms"]) / stage1_ms
    print(label, json.dumps(out), flush=True)
    return out


def reduce_trace(trace_dir, hlo_dir):
    """Device time per HLO module and per (module, scope).  Modules are
    keyed by name and program id (the number in the dump's file name)."""
    op_names = {}
    for path in glob.glob(os.path.join(hlo_dir, "*after_optimizations.txt")):
        pid = int(re.match(r"module_(\d+)", os.path.basename(path)).group(1))
        for line in open(path):
            m = re.match(r'\s*(?:ROOT )?%?([\w.\-]+) = .*op_name="([^"]*)"',
                         line)
            if m:
                op_names[(pid, m.group(1))] = m.group(2)
    pb = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                   recursive=True)[-1]
    pd = jax.profiler.ProfileData.from_file(pb)
    per_module = collections.Counter()
    per_scope = collections.Counter()
    per_line = collections.Counter()
    for plane in pd.planes:
        for line in plane.lines:
            if line.name.startswith("XLA"):  # derived summary lines
                continue
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_module" not in st:
                    continue
                pid = st.get("program_id")
                module = f"{st['hlo_module']}#{pid}"
                name = op_names.get((pid, st.get("hlo_op")), "")
                scope = ("tone_power" if "tone_power" in name
                         else "stage1" if "stage1" in name else "other")
                per_module[module] += ev.duration_ns / 1e6
                per_scope[(module, scope)] += ev.duration_ns / 1e6
                per_line[f"{plane.name}|{line.name}"] += ev.duration_ns / 1e6
    print("ms per trace line:", dict(per_line.most_common(8)))
    return per_module, per_scope


def main():
    os.makedirs(OUT, exist_ok=True)
    print("card:", os.popen("nvidia-smi --query-gpu=name,power.limit "
                            "--format=csv,noheader").read().strip())
    print("device:", jax.devices()[0].device_kind, "jax", jax.__version__)
    n_power, d_pcm = int(FS / 10), int(round(FS / 25))
    npcm = int(np.round(FS / CFG.bitrate * (1 - CFG.phase_error / 100))) \
        - 2 * CFG.bit_inset

    # batch: 8 x 60 s int16 rows
    rows, _ = simulator.noisy_rows(8, simulator.SimSpec(
        duration=BATCH_S, profile_start=40.0, seed=21))
    dims = eng.EngineDims.for_waveform(rows.shape[1], FS, CFG.bitrate, npcm)
    ptrig, btrig, sos = eng.engine_tables(CFG, FS, dims)
    stage1 = pipeline._batched_stage1(dims, FS, float(CFG.bitrate),
                                      CFG.bit_inset, 100)
    xb = jnp.asarray(rows)
    nv = jnp.full((8,), rows.shape[1], jnp.int32)
    consts = [jnp.asarray(a, jnp.float32) for a in (ptrig, sos, btrig)]
    s1_ms = median_ms(stage1, xb, nv, *consts)
    xf = jnp.asarray(((rows - rows.mean(1, keepdims=True))
                      / np.abs(rows).max(1, keepdims=True)).astype(np.float32))
    starts = jnp.arange(dims.max_edges, dtype=jnp.int32) * 55
    res = {"batch": alone("batch", xf, starts, consts[0], consts[2], n_power,
                          d_pcm, npcm, s1_ms)}

    # segmented: one 600 s drop, stage 1 = n_chunk grouped programs
    spec = simulator.SimSpec(duration=DROP_S, profile_start=33.0, seed=11)
    pcm600, _ = simulator.synthesize(spec)
    raw = np.round(pcm600 * (28000 / np.max(np.abs(pcm600)))).astype(np.int16)
    p = segmented._plan_waveform(raw, FS, None, "auto", StageTimer())
    chunks = [segmented._chunk_host(p, j) for j in range(p.n_chunk)]
    chunks = [(jnp.asarray(e), jnp.asarray(k)) for e, k in chunks]

    def seg_stage1():
        return [p.vseg(e, p.dc_d, p.peak_d, k, p.nv_raw, p.pt, p.so, p.bt,
                       p.ds) for e, k in chunks]

    s1_ms = median_ms(seg_stage1, reps=10)
    n_rows = p.n_chunk * segmented.GROUP
    body = p.seg_len + p.right
    xs = jnp.asarray(np.resize(np.asarray(xf[0]), (n_rows, body)))
    starts = jnp.arange(body // 64, dtype=jnp.int32) * 55
    res["segmented"] = alone("segmented", xs, starts, p.pt, p.bt, n_power,
                             d_pcm, npcm, s1_ms)

    # traces of the whole decodes
    trace_dir = os.path.join(WORK, "trace")
    batch.decode_batch(rows, 44100)
    segmented.decode_waveform_segmented(raw, 44100)
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            batch.decode_batch(rows, 44100)
        for _ in range(3):
            segmented.decode_waveform_segmented(raw, 44100)
    per_module, per_scope = reduce_trace(trace_dir, os.path.join(WORK, "hlo"))
    print("device ms per module (3 decodes each; CPU rehearsals count host"
          " threads):")
    for module, ms in per_module.most_common(12):
        scopes = {s: round(v, 3) for (m, s), v in per_scope.items()
                  if m == module}
        print(f"  {ms:10.3f}  {module}  {scopes}")
    res["trace_modules"] = {m: round(v, 4) for m, v in per_module.items()}
    res["trace_scopes"] = {f"{m}|{s}": round(v, 4)
                           for (m, s), v in per_scope.items()}
    with open(os.path.join(OUT, "stage1.json"), "w") as f:
        json.dump(res, f, indent=1)
    keep = glob.glob(os.path.join(WORK, "hlo", "*after_optimizations.txt"))
    keep += [p for p in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                                  recursive=True)
             if os.path.getsize(p) < 20e6]
    for path in keep:
        with open(path, "rb") as src, gzip.open(os.path.join(
                OUT, os.path.basename(path) + ".gz"), "wb") as dst:
            shutil.copyfileobj(src, dst)
    shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
