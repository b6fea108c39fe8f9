#!/usr/bin/env python3
"""On-chip differencing of the segment program's pieces.

Times cumulative sub-programs (each returning ONE scalar so the fetch
cost is constant) and prints the differences: conditioning+filter FFT,
tone powers, crossing compaction, probes.  Differencing cancels the
per-dispatch and fetch overhead common to every sub-program.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from axctdprocessor_tpu.models import segmented, tpu_engine as eng
from axctdprocessor_tpu.ops import chain as chain_ops
from axctdprocessor_tpu.ops import goertzel, iir
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


def main():
    print("backend:", jax.default_backend())
    cfg = DecoderConfig()
    d_pcm, n_power, seg_len, right, c_seg = segmented._seg_geometry(FS)
    npcm = int(np.round(FS / cfg.bitrate * 0.75)) - 2 * cfg.bit_inset
    ext_len = segmented.LEFT_HALO + seg_len + right
    nfft = iir.next_pow2(ext_len)
    print(f"seg_len={seg_len} ext={ext_len} nfft={nfft} c_seg={c_seg}")

    rng = np.random.default_rng(0)
    t = np.arange(ext_len) / FS
    x = (0.5 * np.sin(2 * np.pi * 567 * t)
         + 0.1 * rng.standard_normal(ext_len)).astype(np.float32)
    xd = jnp.asarray(x)
    ptrig = jnp.asarray(goertzel.tone_matrix(
        n_power, [400.0, 7500.0, 3000.0], FS, dtype=np.float32))
    sos = jnp.asarray(iir.design_sos(FS, False), jnp.float32)
    btrig = jnp.asarray(goertzel.tone_matrix(
        npcm, [400.0, 800.0], FS, dtype=np.float32))

    def filt_part(x):
        resp = eng.sos_response_on_device(sos, nfft)
        spec = jnp.fft.rfft(x, nfft) * resp
        return jnp.fft.irfft(spec, nfft)[:ext_len].astype(jnp.float32)

    def powers_part(x):
        body = x[: seg_len + right]
        return goertzel.framed_tone_power_tiled(body, n_power, d_pcm, ptrig)

    def cross_part(filt):
        sgn = jnp.where(filt >= 0, 1, -1)
        is_c = sgn[:seg_len] != sgn[1 : seg_len + 1]
        return chain_ops.compact_indices(is_c, c_seg, BIG)

    def cross_part_rowcap(filt):
        sgn = jnp.where(filt >= 0, 1, -1)
        is_c = sgn[:seg_len] != sgn[1 : seg_len + 1]
        return chain_ops.compact_indices_rowcap(is_c, c_seg, BIG)[:2]

    def probes_part(filt, pos):
        return goertzel.tone_power_at(
            filt[: seg_len + right],
            jnp.clip(pos, 0, seg_len - 1) + cfg.bit_inset, npcm, btrig)

    a = jax.jit(lambda x: filt_part(x)[0])
    b = jax.jit(lambda x: filt_part(x)[0] + powers_part(x)[0, 0])
    c = jax.jit(lambda x: (lambda f: f[0] + powers_part(x)[0, 0]
                           + cross_part(f)[0][0].astype(jnp.float32))(
                               filt_part(x)))
    d = jax.jit(lambda x: (lambda f: (lambda pos: f[0]
                           + powers_part(x)[0, 0]
                           + pos[0].astype(jnp.float32)
                           + probes_part(f, pos)[0, 0])(
                               cross_part(f)[0]))(filt_part(x)))

    e = jax.jit(lambda x: (lambda f: (lambda pos: f[0]
                           + powers_part(x)[0, 0]
                           + pos[0].astype(jnp.float32)
                           + probes_part(f, pos)[0, 0])(
                               cross_part_rowcap(f)[0]))(filt_part(x)))

    base = timeit(jax.jit(lambda x: x[0]), xd)
    ta = timeit(a, xd)
    tb = timeit(b, xd)
    tc = timeit(c, xd)
    td = timeit(d, xd)
    te = timeit(e, xd)
    print(f"dispatch overhead:    {base*1e3:6.1f} ms")
    print(f"filter (fft):         {(ta-base)*1e3:6.1f} ms")
    print(f"+ tone powers:        {(tb-ta)*1e3:6.1f} ms")
    print(f"+ crossings compact:  {(tc-tb)*1e3:6.1f} ms")
    print(f"+ probes:             {(td-tc)*1e3:6.1f} ms")
    print(f"sum (~segment prog):  {(td-base)*1e3:6.1f} ms")
    print(f"sum w/ rowcap compact:{(te-base)*1e3:6.1f} ms")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("seg_pieces", main)
