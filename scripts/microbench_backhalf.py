#!/usr/bin/env python3
"""On-chip decomposition of back_half_core (the assemble program's
device back half at 600 s scale): times each sub-stage independently on
realistic-shaped random inputs, plus the expensive stage-2 primitives
(CRC all-windows, frame sync, frame-window gather, QC percentile
sorts) in isolation.  Each timed program folds its full output into one
scalar so XLA cannot dead-code the work and the fetch cost is constant.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from axctdprocessor_tpu.models import segmented, tpu_engine as eng
from axctdprocessor_tpu.ops import chain as chain_ops
from axctdprocessor_tpu.ops import crc as crc_ops
from axctdprocessor_tpu.ops import header_device as hdr_ops
from axctdprocessor_tpu.utils.config import DecoderConfig

FS = 44100.0
REPS = 5
BIG = segmented.BIG


def timeit(fn, *args):
    out = fn(*args)
    _ = float(jax.device_get(out))
    best = 1e9
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = float(jax.device_get(out))
        best = min(best, time.perf_counter() - t0)
    return best


def force(*arrs):
    return sum(jnp.sum(jnp.asarray(a).astype(jnp.float32)) for a in arrs)


def main():
    print("backend:", jax.default_backend())
    cfg = DecoderConfig()
    d_pcm, n_power, seg_len, right, c_seg = segmented._seg_geometry(FS)
    npcm = int(np.round(FS / cfg.bitrate * 0.75)) - 2 * cfg.bit_inset
    n_seg_pad = segmented._bucket_count(int(np.ceil(600.0 * FS / seg_len)))
    dims = eng.EngineDims.for_waveform(n_seg_pad * seg_len, FS, cfg.bitrate,
                                       npcm)
    me, mf = dims.max_edges, dims.max_frames
    n_win = dims.n_win
    print(f"max_edges={me} max_frames={mf} n_win={n_win}")

    rng = np.random.default_rng(0)
    params = eng.fused_inputs(cfg, FS)
    nv = jnp.asarray(int(600 * FS), jnp.int32)

    # realistic merged-domain inputs: ~500k bit edges at ~55 samples/bit
    n_edges_true = min(int(600 * FS / 55.1), me - 8)
    edges = np.full(me, int(600 * FS), np.int32)
    edges[:n_edges_true] = np.sort(
        rng.choice(int(600 * FS) - 100, n_edges_true, replace=False))
    edges_d = jnp.asarray(edges)
    n_edges_d = jnp.asarray(n_edges_true, jnp.int32)
    s1 = jnp.asarray(rng.random(me).astype(np.float32) + 0.1)
    s2 = jnp.asarray(rng.random(me).astype(np.float32) + 0.1)
    r400 = jnp.asarray((rng.random(n_win).astype(np.float32) - 0.2) * 3)
    r7500 = jnp.asarray((rng.random(n_win).astype(np.float32) - 0.2) * 3)
    bits = jnp.asarray((rng.random(me) < 0.5).astype(np.int32))
    hb = jnp.asarray(np.array([int(2.0 * FS), int(4.0 * FS),
                               int(10.0 * FS), int(15.5 * FS),
                               int(19.5 * FS), int(25.0 * FS)], np.int32))

    t_base = timeit(jax.jit(lambda a: a[0]), s1)

    t_trig = timeit(jax.jit(
        lambda a, b: force(*eng.trigger_core(a, b, nv, params["trig_i"],
                                             params["trig_f"], dims, FS))),
        r400, r7500)

    c0 = s2 / jnp.maximum(s1, 1e-30)
    t_s15 = timeit(jax.jit(
        lambda a, e: force(*eng.stage15_core(
            a, e, n_edges_d, hb, jnp.asarray(int(3 * FS), jnp.int32),
            dims).values())), c0, edges_d)

    hbits = jnp.asarray((rng.random(eng.HEADER_WINDOW_BITS) < 0.5)
                        .astype(jnp.int32))
    hn = jnp.asarray(4000, jnp.int32)

    def hdr_part(hb_, hn_):
        f2, fr2, u2 = hdr_ops.parse_header_window(hb_, hn_)
        v2, ok2, _, _, crash2 = hdr_ops.decode_coefficients(f2, fr2)
        lz, lt, lc = hdr_ops.merge_live_coeffs(
            v2, ok2 & ~crash2, v2, ok2 & ~crash2, params["coeff_defaults"])
        return force(f2, fr2, u2, v2, lz, lt, lc)

    t_hdr = timeit(jax.jit(hdr_part), hbits, hn)

    t_s2 = timeit(jax.jit(
        lambda b, e, a, c: force(*eng.stage2_core(
            b, n_edges_d - 1, e, a, c, jnp.asarray(0.5, jnp.float32),
            jnp.asarray(int(33 * FS), jnp.int32), dims, FS).values())),
        bits, edges_d, r400, r7500)

    # stage-2 primitives in isolation
    t_crc = timeit(jax.jit(
        lambda b: force(crc_ops.check_crc_all_windows(b))), bits)

    accept_np = np.zeros(me, bool)
    accept_np[rng.choice(n_edges_true - 40, n_edges_true // 34,
                         replace=False)] = True
    accept_d = jnp.asarray(accept_np)
    t_sync = timeit(jax.jit(
        lambda a: force(*chain_ops.enumerate_frames(
            a, jnp.asarray(n_edges_true, jnp.int32), max_steps=me,
            max_frames=mf))), accept_d)

    starts_d = jnp.asarray(np.sort(rng.choice(me - 40, mf).astype(np.int32)))
    t_fwin = timeit(jax.jit(
        lambda b, s: force(b[s[:, None] + jnp.arange(32)[None, :]])),
        bits, starts_d)

    words = jnp.asarray(rng.integers(0, 2**32, me, np.uint32,
                                     endpoint=False))
    t_crcw = timeit(jax.jit(
        lambda w: force(crc_ops.check_crc_words(w))), words)

    roll_amt = jnp.asarray(1000, jnp.int32)
    t_roll = timeit(jax.jit(
        lambda b, e: force(jnp.roll(b, -roll_amt), jnp.roll(e, -roll_amt))),
        bits, edges_d)

    print(f"dispatch overhead:     {t_base*1e3:6.1f} ms")
    print(f"trigger_core:          {(t_trig-t_base)*1e3:6.1f} ms")
    print(f"stage15_core:          {(t_s15-t_base)*1e3:6.1f} ms")
    print(f"header parse+decode:   {(t_hdr-t_base)*1e3:6.1f} ms")
    print(f"stage2_core:           {(t_s2-t_base)*1e3:6.1f} ms")
    print("stage-2 primitives:")
    print(f"  crc all-windows:     {(t_crc-t_base)*1e3:6.1f} ms")
    print(f"  frame sync:          {(t_sync-t_base)*1e3:6.1f} ms")
    print(f"  frame-window gather: {(t_fwin-t_base)*1e3:6.1f} ms")
    print(f"  crc from words:      {(t_crcw-t_base)*1e3:6.1f} ms")
    print(f"  2 rolls (bits+edges):{(t_roll-t_base)*1e3:6.1f} ms")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("backhalf", main)
