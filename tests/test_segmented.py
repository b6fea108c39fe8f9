"""Segmented decode vs the monolithic fused engine."""

import numpy as np
import pytest

from axctdprocessor_tpu.models import segmented, simulator
from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu


@pytest.fixture(scope="module")
def drop130():
    """A 130 s drop: 3 segments (bucket 3; zero-segment padding has its
    own forced-bucket test below)."""
    spec = simulator.SimSpec(duration=130.0, profile_start=33.0, seed=91)
    pcm, truth = simulator.synthesize(spec)
    return pcm, truth


def _conditioned(pcm):
    return ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)


def test_segmented_matches_monolithic(drop130):
    pcm, truth = drop130
    x = _conditioned(pcm)
    mono = decode_waveform_tpu(x, 44100)
    seg = segmented.decode_waveform_segmented(x, 44100)
    assert seg.status == mono.status == 2
    assert seg.metadata == mono.metadata
    assert seg.firstpulse400 == mono.firstpulse400
    assert seg.profstartind == mono.profstartind
    a, b = set(seg.hexframes), set(mono.hexframes)
    assert len(a & b) / max(len(a | b), 1) > 0.98
    # values on the common frames agree
    common = min(len(seg.time), len(mono.time))
    assert common > 0.95 * max(len(seg.time), len(mono.time))


def test_segmented_int16_device_conditioning(drop130):
    """Raw int16 through the segmented path (host f64 DC/peak, device
    conditioning) decodes like the host-conditioned float path."""
    pcm, truth = drop130
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    res_i = segmented.decode_waveform_segmented(raw, 44100)
    cond = ((raw.astype(np.float64) - np.mean(raw))
            / np.max(np.abs(raw))).astype(np.float32)
    res_f = segmented.decode_waveform_segmented(cond, 44100)
    assert res_i.status == 2
    assert res_i.metadata["serial_no"] == truth["serial_no"]
    assert res_i.hexframes == res_f.hexframes


@pytest.mark.slow
def test_segment_program_shared_across_lengths(drop130):
    """A different file length reuses the cached segment program — no new
    stage-1 compilation, the whole point of segmenting."""
    pcm, truth = drop130
    x = _conditioned(pcm)
    # warm the (fs, geometry) program key with a decode of a DIFFERENT
    # length first (self-contained: xdist may schedule this test onto a
    # worker where nothing has decoded yet)
    segmented.decode_waveform_segmented(x[: int(60 * 44100)], 44100)
    seg_info_before = segmented._segment_program_grouped.cache_info()
    res70 = segmented.decode_waveform_segmented(x[: int(70 * 44100)], 44100)
    seg_info_after = segmented._segment_program_grouped.cache_info()
    assert res70.status == 2
    assert res70.metadata["serial_no"] == truth["serial_no"]
    # same (fs, geometry) key -> cache hit, no new segment program
    assert seg_info_after.misses == seg_info_before.misses


@pytest.mark.slow
def test_segmented_highrate_decimation():
    """An 88.2 kHz int16 drop through the segmented path (per-segment
    device decimation) matches the monolithic decimating engine."""
    spec = simulator.SimSpec(fs=88200, duration=70.0, profile_start=33.0,
                             seed=41)
    pcm, truth = simulator.synthesize(spec)
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)

    seg = segmented.decode_waveform_segmented(raw, 88200)
    mono = decode_waveform_tpu(raw, 88200, mode="monolithic")
    assert seg.status == mono.status == 2
    assert seg.metadata["serial_no"] == truth["serial_no"]
    assert seg.metadata == mono.metadata
    assert isinstance(seg.fs, float) and seg.fs == 44100.0
    assert seg.numpoints == (len(raw) + 1) // 2 == mono.numpoints
    a, b = set(seg.hexframes), set(mono.hexframes)
    assert len(a & b) / max(len(a | b), 1) > 0.98


def test_zero_segment_padding_is_neutral(drop130, monkeypatch):
    """Bucket padding appends shared zero segments; they must not change
    the decode (130 s = 3 real segments; force a 6-segment bucket)."""
    pcm, truth = drop130
    x = _conditioned(pcm)
    base = segmented.decode_waveform_segmented(x, 44100)
    monkeypatch.setattr(segmented, "_bucket_count", lambda k: 6)
    padded = segmented.decode_waveform_segmented(x, 44100)
    assert padded.status == base.status == 2
    assert padded.metadata == base.metadata
    assert padded.hexframes == base.hexframes
    assert padded.time == base.time


@pytest.mark.slow
def test_grouped_dispatch_matches_per_segment_loop(drop130):
    """The product decode path (GROUP-segment vmapped dispatch + chunked
    assemble — what decode_waveform_segmented now ships) decodes
    identically to a one-dispatch-per-segment loop over the stream
    decoder's program pair (_segment_program + the tuple assemble)."""
    import jax
    import jax.numpy as jnp

    from axctdprocessor_tpu.models import tpu_engine as eng
    from axctdprocessor_tpu.ops import wire as wire_ops
    from axctdprocessor_tpu.utils.config import DecoderConfig

    pcm, truth = drop130
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)

    cfg = DecoderConfig()
    fs = 44100.0
    q = wire_ops.quantize_int8(raw)
    n = len(q)
    d_pcm, n_power, seg_len, right, c_seg = segmented._seg_geometry(fs)
    npcm = (int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100)))
            - 2 * cfg.bit_inset)
    ext_len = segmented.LEFT_HALO + seg_len + right
    n_seg = max(int(np.ceil(n / seg_len)), 1)
    n_seg_pad = segmented._bucket_count(n_seg)
    dims = eng.EngineDims.for_waveform(n_seg_pad * seg_len, fs,
                                       cfg.bitrate, npcm)
    power_trig, bit_trig, sos = eng.engine_tables(cfg, fs, dims)
    seg_fn = segmented._segment_program(fs, npcm, cfg.bit_inset, 100, True)
    pt, so, bt = (jnp.asarray(a, jnp.float32)
                  for a in (power_trig, sos, bit_trig))
    ds = jnp.asarray(np.zeros((1, 6)), jnp.float32)
    dc = jnp.asarray(np.float32(np.mean(q)))
    peak = jnp.asarray(np.float32(max(int(q.max()), -int(q.min()), 1)))
    nv = jnp.asarray(n, jnp.int32)

    def build_ext(k):
        if k >= n_seg:
            return np.zeros(ext_len, q.dtype)
        lo = k * seg_len - segmented.LEFT_HALO
        hi = k * seg_len + seg_len + right
        ext = np.zeros(ext_len, q.dtype)
        s_lo, s_hi = max(lo, 0), min(hi, n)
        ext[s_lo - lo: s_hi - lo] = q[s_lo:s_hi]
        return ext

    params = eng.fused_inputs(cfg, fs)

    # base: one dispatch per segment + the tuple assemble (the realtime
    # stream decoder's exact program pair)
    asm_loop = segmented._assemble_program(n_seg_pad, dims, fs,
                                           float(cfg.bitrate))
    outs_l = [seg_fn(jnp.asarray(build_ext(k)), dc, peak,
                     jnp.asarray(min(k, n_seg) * seg_len, np.int32),
                     nv, pt, so, bt, ds)
              for k in range(n_seg_pad)]
    out_l = asm_loop(*[tuple(o[i] for o in outs_l) for i in range(5)],
                     nv, params["trig_i"], params["trig_f"],
                     params["hdr_rel"], params["calib_off"],
                     params["coeff_defaults"], params["temp_lut"],
                     params["limits"])
    base = eng.finish_result(jax.device_get(out_l), 44100, n, fs, cfg)

    # the product path: grouped dispatch inside decode_waveform_segmented
    res = segmented.decode_waveform_segmented(raw, 44100, wire="int8")
    assert res.status == base.status == 2
    assert res.metadata == base.metadata
    assert res.hexframes == base.hexframes


@pytest.mark.slow
def test_prestaged_decode_matches_segmented(drop130):
    """prestage_waveform + PrestagedDrop.decode() (the public resident
    API bench.py's resident child times) must equal the streamed-upload
    decode, and back-to-back async dispatches must each finish to the
    same result."""
    pcm, truth = drop130
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)

    base = segmented.decode_waveform_segmented(raw, 44100, wire="int8")
    st = segmented.prestage_waveform(raw, 44100, wire="int8")
    res = st.decode()
    assert res.status == base.status == 2
    assert res.metadata == base.metadata
    assert res.hexframes == base.hexframes
    assert res.time == base.time

    outs = [st.dispatch() for _ in range(2)]  # pipelined corpus shape
    for o in outs:
        r = st.finish(o)
        assert r.hexframes == base.hexframes

    # the fused single-dispatch resident program (lax.map over chunks)
    st_f = segmented.prestage_waveform(raw, 44100, wire="int8", fused=True)
    res_f = st_f.decode()
    assert res_f.status == 2
    assert res_f.metadata == base.metadata
    assert res_f.hexframes == base.hexframes
    assert res_f.time == base.time


def test_bucket_count():
    ks = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13, 16, 17, 24, 25, 29, 57)
    want = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 64)
    assert tuple(segmented._bucket_count(k) for k in ks) == want
    for k in range(1, 2000):
        b = segmented._bucket_count(k)
        assert b >= k and b <= max(int(np.ceil(k * 1.25)), k + 1)


@pytest.mark.slow
def test_auto_route_over_300s_matches_parity():
    """The auto-segment route (decode_waveform_tpu, files > 300 s) is the
    path every real ~10-min drop takes; exercise it end-to-end at 310 s
    against the byte-exact parity engine with bounded frame/value drift
    (the engines differ by documented chunk-semantics deviations only)."""
    from axctdprocessor_tpu.models.parity_engine import decode_waveform

    spec = simulator.SimSpec(duration=310.0, profile_start=33.0, seed=77)
    pcm, truth = simulator.synthesize(spec)
    x = _conditioned(pcm)

    dev = decode_waveform_tpu(x, 44100)          # auto-routes: > 300 s
    host = decode_waveform(x.astype(np.float64), 44100)

    assert dev.status == host.status == 2
    assert dev.metadata["serial_no"] == host.metadata["serial_no"] \
        == truth["serial_no"]
    assert dev.metadata == host.metadata
    assert dev.firstpulse400 == host.firstpulse400
    assert dev.overflow == 0
    # demod/frame-sync agreement: near-perfect at full scale (measured
    # 1.0 on this drop; leave headroom for float jitter)
    a, b = set(dev.hexframes), set(host.hexframes)
    assert len(a & b) / max(len(a | b), 1) > 0.99
    # QC'd row counts drift more (per-bit r-value tagging differs by the
    # documented uniform-grid-vs-chunk-local deviation, flipping rows
    # that straddle the thresholds) — bound it loosely
    assert abs(len(dev.time) - len(host.time)) < 0.10 * len(host.time)
    # values joined BY FRAME must match exactly: temperature depends only
    # on the frame bits + decoded coefficients (both engines round to 2)
    # frames repeat heavily (profile values plateau: ~1750 unique among
    # ~6500 rows), so the frame-keyed join is over UNIQUE frames; nearly
    # all of the host's QC'd frames must appear on the device side
    # (measured: 1497 common of host's 1509 unique)
    t_tpu = {h: t for h, t in zip(dev.hexframes_qc, dev.temperature)}
    t_host = {h: t for h, t in zip(host.hexframes_qc, host.temperature)}
    common = set(t_tpu) & set(t_host)
    assert len(common) > 0.95 * len(set(host.hexframes_qc)) > 1000
    diffs = [abs(t_tpu[h] - t_host[h]) for h in common]
    assert np.median(diffs) < 0.011 and np.mean(diffs) < 0.02


@pytest.mark.slow
def test_segmented_highrate_no_bogus_timeout():
    """Decim2 regression: the assemble/back half must see the DECODE-rate
    valid length.  A raw-rate count doubles the apparent grid, which let
    the fixed-compat hard timeout fire on recordings shorter than the
    timeout (status 2 with a garbage profile instead of status 1)."""
    spec = simulator.SimSpec(fs=88200, duration=40.0, profile_start=1e9,
                             seed=13)  # pulse, never a 7500 tone
    pcm, _ = simulator.synthesize(spec)
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    settings = {"triggerrange": [30, 60]}  # timeout at 60 s > 40 s file
    from axctdprocessor_tpu.utils.config import resolve_settings

    cfg = resolve_settings(settings, compat="fixed")
    res = segmented.decode_waveform_segmented(raw, 88200, config=cfg)
    assert res.status == 1  # pulse found, no trigger — and no timeout


def test_segmented_no_pulse():
    rng = np.random.default_rng(5)
    noise = (rng.standard_normal(int(70 * 44100)) * 0.3).astype(np.float32)
    res = segmented.decode_waveform_segmented(noise, 44100)
    assert res.status == 0
    assert res.time == []
