#!/usr/bin/env python3
"""On-chip differencing of the assemble program's pieces at 600 s scale.

Cumulative sub-programs (single-scalar outputs) isolate: power
smoothing, crossing merge/compaction, the bit-edge chain, and the full
device back half (trigger + calibration + headers + profile stage).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from axctdprocessor_tpu.models import segmented, tpu_engine as eng
from axctdprocessor_tpu.ops import chain as chain_ops
from axctdprocessor_tpu.ops import iir
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
    strides = seg_len // d_pcm
    npcm = int(np.round(FS / cfg.bitrate * 0.75)) - 2 * cfg.bit_inset
    n_seg = max(int(np.ceil(600.0 * FS / seg_len)), 1)
    n_seg_pad = segmented._bucket_count(n_seg)
    dims = eng.EngineDims.for_waveform(n_seg_pad * seg_len, FS, cfg.bitrate,
                                       npcm)
    total = n_seg_pad * c_seg
    print(f"n_seg={n_seg} pad={n_seg_pad} total_cross={total} "
          f"max_edges={dims.max_edges}")

    rng = np.random.default_rng(0)
    powers = rng.random((n_seg_pad, strides, 3)).astype(np.float32) + 0.1
    # realistic crossing fill: ~1400/s of the 3000/s capacity
    gpos = np.full((n_seg_pad, c_seg), BIG, np.int32)
    n_fill = int(seg_len / FS * 1400)
    for k in range(n_seg):
        pos = np.sort(rng.choice(seg_len, n_fill, replace=False))
        gpos[k, :n_fill] = pos + k * seg_len
    c0 = (rng.random((n_seg_pad, c_seg)).astype(np.float32) + 0.1)

    params = eng.fused_inputs(cfg, FS)
    nv = jnp.asarray(int(600 * FS), jnp.int32)
    pw, gp, c0d = (jnp.asarray(a) for a in (powers, gpos, c0))

    def smooth(pwr):
        p = pwr.reshape(-1, pwr.shape[-1])
        sm = [iir.boxsmooth_lag(p[:, i], 5) for i in range(3)]
        return jnp.log10(sm[0] / sm[2]), jnp.log10(sm[1] / sm[2])

    cnt_host = np.asarray((gpos < BIG).sum(axis=1), np.int32)
    cnt_d = jnp.asarray(cnt_host)

    def merge(g, q1):
        # production ragged-concatenation merge (segmented._assemble_program)
        from jax import lax

        k_seg_, c_seg_ = g.shape
        m = k_seg_ * c_seg_
        cnts = jnp.minimum(cnt_d, c_seg_)
        coff = jnp.cumsum(cnts) - cnts
        n_cross = coff[-1] + cnts[-1]
        buf_g = jnp.full((m,), BIG, jnp.int32)
        buf_c0 = jnp.zeros((m,), q1.dtype)
        for k in range(k_seg_):
            at = (coff[k],)
            buf_g = lax.dynamic_update_slice(buf_g, g[k], at)
            buf_c0 = lax.dynamic_update_slice(buf_c0, q1[k], at)
        g_s = jnp.where(jnp.arange(m) < n_cross, buf_g, BIG)
        return g_s, buf_c0, n_cross

    # every stage's FULL output folds into the scalar via sums, so XLA
    # cannot dead-code-eliminate the work behind a [0] index
    def force(*arrs):
        return sum(jnp.sum(a.astype(jnp.float32)) for a in arrs)

    a = jax.jit(lambda pwr: force(*smooth(pwr)))
    b = jax.jit(lambda pwr, g, q1: force(*smooth(pwr),
                                         merge(g, q1)[0]))

    def upto_probes(pwr, g, q1):
        r400, r7500 = smooth(pwr)
        g_s, q1s, n_cross = merge(g, q1)
        return force(r400, r7500, g_s, q1s), \
            (r400, r7500, g_s, q1s, n_cross)

    c = jax.jit(lambda pwr, g, q1: upto_probes(pwr, g, q1)[0])

    def upto_chain(pwr, g, q1):
        s, (r400, r7500, g_s, q1s, n_cross) = upto_probes(pwr, g, q1)
        edge_idx, n_edges = chain_ops.enumerate_bit_edges(
            g_s, n_cross, FS, float(cfg.bitrate), dims.max_edges)
        return s + force(edge_idx), \
            (r400, r7500, g_s, q1s, edge_idx, n_edges)

    d = jax.jit(lambda pwr, g, q1: upto_chain(pwr, g, q1)[0])

    def backhalf_upto(level: int):
        """Cumulative in-context cuts INSIDE the back half: isolated
        pieces (microbench_backhalf) can sum to far less than the
        in-program back half — layout/fusion choices XLA makes only in
        the full program — so the decomposition runs in context."""

        def f(pwr, g, q1):
            s, (r400, r7500, g_s, q1s, edge_idx, n_edges) = \
                upto_chain(pwr, g, q1)
            safe = jnp.clip(edge_idx, 0, g_s.shape[0] - 1)
            es, c0p = g_s[safe], q1s[safe]
            s = s + force(es, c0p)
            if level == 0:  # + the 2 edge gathers over the 2M table
                return s
            fp, mean7500, profstart = eng.trigger_core(
                r400, r7500, nv, params["trig_i"], params["trig_f"],
                dims, FS)
            s = s + force(fp, mean7500, profstart)
            if level == 1:  # + trigger
                return s
            big = jnp.int32(2 ** 30)
            lo_mask = jnp.asarray([True, False, True, False, True, False])
            hb = jnp.where(fp >= 0, fp + params["hdr_rel"],
                           jnp.where(lo_mask, big, -big))
            s15 = eng.stage15_core(c0p, es, n_edges, hb,
                                   fp + params["calib_off"], dims)
            s = s + force(*s15.values())
            if level == 2:  # + stage 1.5 (bits + calibration + windows)
                return s
            from axctdprocessor_tpu.ops import header_device as hdr_ops

            h2f, h2fr, h2u = hdr_ops.parse_header_window(
                s15["h2_bits"], s15["h2_n"])
            h3f, h3fr, h3u = hdr_ops.parse_header_window(
                s15["h3_bits"], s15["h3_n"])
            s = s + force(h2f, h2fr, h2u, h3f, h3fr, h3u)
            if level == 3:  # + header parse/decode
                return s
            out = eng.stage2_core(s15["bits"], n_edges - 1, es, r400,
                                  r7500, mean7500, profstart, dims, FS)
            return s + force(*out.values())

        return jax.jit(f)

    def full(pwr, g, q1):
        s, (r400, r7500, g_s, q1s, edge_idx, n_edges) = \
            upto_chain(pwr, g, q1)
        safe = jnp.clip(edge_idx, 0, g_s.shape[0] - 1)
        out = eng.back_half_core(
            r400, r7500, g_s[safe], n_edges, q1s[safe], nv,
            params["trig_i"], params["trig_f"], params["hdr_rel"],
            params["calib_off"], params["coeff_defaults"],
            params["temp_lut"], params["limits"], dims, FS)
        return s + force(out)  # packed single-vector result

    e = jax.jit(full)

    base = timeit(jax.jit(lambda pwr: pwr[0, 0, 0]), pw)
    ta = timeit(a, pw)
    tb = timeit(b, pw, gp, c0d)
    tc = timeit(c, pw, gp, c0d)
    td = timeit(d, pw, gp, c0d)
    tg = timeit(backhalf_upto(0), pw, gp, c0d)
    t1 = timeit(backhalf_upto(1), pw, gp, c0d)
    t2 = timeit(backhalf_upto(2), pw, gp, c0d)
    t3 = timeit(backhalf_upto(3), pw, gp, c0d)
    t4 = timeit(backhalf_upto(4), pw, gp, c0d)
    te = timeit(e, pw, gp, c0d)
    print(f"dispatch overhead:      {base*1e3:6.1f} ms")
    print(f"power smoothing:        {(ta-base)*1e3:6.1f} ms")
    print(f"+ ragged merge (g+p):   {(tb-ta)*1e3:6.1f} ms")
    print(f"+ (merge force delta):  {(tc-tb)*1e3:6.1f} ms")
    print(f"+ bit-edge chain:       {(td-tc)*1e3:6.1f} ms")
    print(f"+ edge gathers (2):     {(tg-td)*1e3:6.1f} ms")
    print(f"+ trigger:              {(t1-tg)*1e3:6.1f} ms")
    print(f"+ stage 1.5:            {(t2-t1)*1e3:6.1f} ms")
    print(f"+ header parse:         {(t3-t2)*1e3:6.1f} ms")
    print(f"+ stage 2:              {(t4-t3)*1e3:6.1f} ms")
    print(f"+ pack (full-t4):       {(te-t4)*1e3:6.1f} ms")
    print(f"back half (full-chain): {(te-td)*1e3:6.1f} ms")
    print(f"total (~assemble):      {(te-base)*1e3:6.1f} ms")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("assemble_pieces", main)
