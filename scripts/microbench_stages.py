#!/usr/bin/env python3
"""On-chip stage timing for the segmented decoder at 600 s scale.

Times (forced-fetch): one stage-1 segment program, its FFT
filter piece alone, the assemble program (smoothing + chain + back
half), and the end-to-end segmented decode — so compute cuts are
attributed to the right stage before restructuring anything.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from axctdprocessor_tpu.models import segmented, simulator, tpu_engine as eng
from axctdprocessor_tpu.ops import iir
from axctdprocessor_tpu.utils.config import DecoderConfig

FS = 44100.0
REPS = 3


def timed(label, fn, *args):
    out = fn(*args)
    leaves = jax.tree_util.tree_leaves(out)
    _ = np.asarray(jax.device_get(leaves[0])).ravel()[:1]
    best = 1e9
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        leaves = jax.tree_util.tree_leaves(out)
        for leaf in leaves:
            _ = np.asarray(jax.device_get(leaf)).ravel()[:1]
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best*1e3:.1f} ms")
    return best


def main():
    print("backend:", jax.default_backend())
    cfg = DecoderConfig()
    spec = simulator.SimSpec(duration=600.0, profile_start=33.0, seed=11)
    pcm, _ = simulator.synthesize(spec)
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    from axctdprocessor_tpu.ops import wire
    q = wire.quantize_int8(raw)

    d_pcm, n_power, seg_len, right, c_seg = segmented._seg_geometry(FS)
    npcm = int(np.round(FS / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    ext_len = segmented.LEFT_HALO + seg_len + right

    n = len(q)
    n_seg = max(int(np.ceil(n / seg_len)), 1)
    n_seg_pad = segmented._bucket_count(n_seg)
    dims = eng.EngineDims.for_waveform(n_seg_pad * seg_len, FS, cfg.bitrate,
                                       npcm)
    power_trig, bit_trig, sos = eng.engine_tables(cfg, FS, dims)
    seg_fn = segmented._segment_program(FS, npcm, cfg.bit_inset, 100, True)
    pt, so, bt = (jnp.asarray(a, jnp.float32)
                  for a in (power_trig, sos, bit_trig))
    ds = jnp.asarray(np.zeros((1, 6)), jnp.float32)
    dc = jnp.asarray(np.float32(np.mean(q)))
    peak = jnp.asarray(np.float32(max(np.max(np.abs(q)), 1)))
    nv = jnp.asarray(n, jnp.int32)

    ext = np.zeros(ext_len, q.dtype)
    ext[: min(ext_len, n)] = q[: min(ext_len, n)]
    ext_d = jax.device_put(jnp.asarray(ext))
    k0 = jnp.asarray(0, jnp.int32)

    timed("segment program (1 of %d)" % n_seg, seg_fn, ext_d, dc, peak, k0,
          nv, pt, so, bt, ds)

    # FFT filter piece alone
    nfft = iir.next_pow2(ext_len)

    @jax.jit
    def fft_only(x, sos_arr):
        xf = x.astype(jnp.float32)
        resp = eng.sos_response_on_device(sos_arr, nfft)
        spec = jnp.fft.rfft(xf, nfft) * resp
        return jnp.fft.irfft(spec, nfft)[:1]

    timed("fft filter alone (%d-pt)" % nfft, fft_only, ext_d, so)

    # assemble program on real per-segment outputs
    outs = [seg_fn(ext_d, dc, peak, jnp.asarray(k * seg_len, jnp.int32), nv,
                   pt, so, bt, ds) for k in range(n_seg)]
    outs += [outs[-1]] * (n_seg_pad - n_seg)
    assemble = segmented._assemble_program(n_seg_pad, dims, FS,
                                           float(cfg.bitrate))
    params = eng.fused_inputs(cfg, FS)
    tup = [tuple(o[i] for o in outs) for i in range(5)]
    timed("assemble program (%d segs)" % n_seg_pad, assemble, *tup, nv,
          params["trig_i"], params["trig_f"], params["hdr_rel"],
          params["calib_off"], params["coeff_defaults"], params["temp_lut"],
          params["limits"])

    t0 = time.perf_counter()
    res = segmented.decode_waveform_segmented(q, FS, config=cfg)
    wall = time.perf_counter() - t0
    print(f"end-to-end segmented decode (warm): {wall*1e3:.1f} ms, "
          f"status={res.status}, rows={len(res.time)}")
    for _ in range(2):
        t0 = time.perf_counter()
        segmented.decode_waveform_segmented(q, FS, config=cfg)
        print(f"  repeat: {(time.perf_counter()-t0)*1e3:.1f} ms")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("stages", main)
