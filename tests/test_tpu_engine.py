"""Fused device engine vs parity engine / encoder truth.

The fused engine is not byte-identical to the reference (documented
deviations: uniform power grid, whole-waveform filtering, true bit
timing instead of the upstream duplicated-index drift), so these tests
check decode *correctness*: metadata exactness, frame recovery rate,
self-consistent physics, and bounded deviation from the parity engine.
"""

import numpy as np
import pytest

from axctdprocessor_tpu.models.parity_engine import decode_waveform
from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu
from axctdprocessor_tpu.models import convert
from axctdprocessor_tpu.ops.bits import hex_to_bits_np
from axctdprocessor_tpu.utils.lut import load_temp_lut
from axctdprocessor_tpu.utils.wavio import read_wav


@pytest.fixture(scope="module")
def engines(default_drop_wav):
    wav, truth = default_drop_wav
    pcm, fs = read_wav(wav)
    par = decode_waveform(pcm, fs)
    fast = decode_waveform_tpu(pcm, fs)
    return par, fast, truth


def test_metadata_exact(engines):
    par, fast, truth = engines
    assert fast.status == 2
    assert fast.metadata["serial_no"] == truth["serial_no"]
    assert fast.metadata["probe_code"] == truth["probe_code"]
    assert fast.metadata["max_depth"] == truth["max_depth"]
    for key in ("tcoeff", "ccoeff", "zcoeff"):
        assert fast.metadata[key] == par.metadata[key], key


def test_trigger_agreement(engines):
    par, fast, _ = engines
    assert fast.firstpulse400 == par.firstpulse400
    # profile trigger may differ by a couple of power windows (grid holes
    # at upstream chunk boundaries); 1764 samples per window
    assert abs(fast.profstartind - par.profstartind) <= 3 * 1764


def test_frame_recovery(engines):
    par, fast, truth = engines
    truth_set = set(truth["frame_hex"])
    in_truth = sum(1 for h in fast.hexframes if h in truth_set)
    assert in_truth / len(fast.hexframes) > 0.97
    # frame counts comparable with parity engine
    assert abs(len(fast.hexframes) - len(par.hexframes)) <= 8


def test_physics_self_consistency(engines):
    """Each emitted row must equal a float64 recomputation from its own hex."""
    _, fast, _ = engines
    lut = load_temp_lut()
    tco = fast.metadata["tcoeff"]
    cco = fast.metadata["ccoeff"]
    for h, t_rep, z_rep, T_rep, C_rep, S_rep in zip(
        fast.hexframes_qc[:100], fast.time, fast.depth, fast.temperature,
        fast.conductivity, fast.salinity,
    ):
        bits = hex_to_bits_np(h)
        tint, cint = convert.frame_ints(bits[None, :])
        T64 = convert.polyval_ascending(np.array([lut[tint[0]]]), tco)[0]
        C64 = convert.polyval_ascending(np.array([cint[0] * 60 / 4096]), cco)[0]
        assert abs(T_rep - round(T64, 2)) <= 0.011, h
        assert abs(C_rep - round(C64, 2)) <= 0.011, h


def _aligned_pairs(a_hex, b_hex):
    """Longest-common-subsequence alignment of the two frame streams."""
    import difflib

    sm = difflib.SequenceMatcher(a=a_hex, b=b_hex, autojunk=False)
    pairs = []
    for block in sm.get_matching_blocks():
        pairs.extend((block.a + k, block.b + k) for k in range(block.size))
    return pairs


def test_values_track_parity_engine(engines):
    par, fast, _ = engines
    pairs = _aligned_pairs(fast.hexframes_qc, par.hexframes_qc)
    assert len(pairs) > 0.9 * min(len(fast.hexframes_qc), len(par.hexframes_qc))
    checked = 0
    for i, j in pairs:
        checked += 1
        assert abs(fast.temperature[i] - par.temperature[j]) <= 0.011
        assert abs(fast.conductivity[i] - par.conductivity[j]) <= 0.011
        # upstream time drift (duplicated buffer indices) + trigger offset
        assert abs(fast.time[i] - par.time[j]) <= 0.25
        assert abs(fast.depth[i] - par.depth[j]) <= 0.8
        assert abs(fast.salinity[i] - par.salinity[j]) <= 0.05
    assert checked > 300


def test_times_monotonic_and_framed(engines):
    _, fast, _ = engines
    t = np.asarray(fast.time)
    assert np.all(np.diff(t) > 0)
    # consecutive frames are multiples of the 0.04 s frame period
    gaps = np.diff(t)
    frac = np.abs(gaps / 0.04 - np.round(gaps / 0.04))
    assert np.percentile(frac, 95) < 0.3


@pytest.mark.slow
def test_cli_tpu_engine(default_drop_wav, tmp_path):
    from axctdprocessor_tpu import cli

    wav, truth = default_drop_wav
    out = tmp_path / "tpu_out.txt"
    assert cli.main(["-i", wav, "-o", str(out), "--engine", "tpu", "--quiet"]) == 0
    text = out.read_text()
    assert "Probe Serial: 00123456" in text
    assert text.count("\n") > 300


@pytest.mark.slow  # ~150 s: second full-length compile; int16 ingest is
# also exercised by test_cli_tpu_engine / test_tpu_engine_timerange
def test_int16_device_conditioning(default_drop_wav):
    """decode_wav_tpu's raw-int16 path equals the host-conditioned path."""
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    wav, truth = default_drop_wav
    res_raw = decode_wav_tpu(wav)  # int16 -> device conditioning
    pcm, fs = read_wav(wav)
    res_f32 = decode_waveform_tpu(pcm.astype(np.float32), fs)
    assert res_raw.metadata["serial_no"] == truth["serial_no"]
    assert res_raw.hexframes == res_f32.hexframes
    assert abs(len(res_raw.time) - len(res_f32.time)) <= 2


def test_length_bucketing_shares_compilation(default_drop_wav):
    """Different file lengths in one 15 s bucket decode identically and
    share EngineDims (i.e. one compilation)."""
    from axctdprocessor_tpu.models.tpu_engine import (
        BUCKET_SECONDS, EngineDims)

    wav, truth = default_drop_wav
    pcm, fs = read_wav(wav)
    full = decode_waveform_tpu(pcm, fs)
    # trim 1.7 s off the end: same bucket, nearly identical decode
    trimmed = decode_waveform_tpu(pcm[: int(len(pcm) - 1.7 * fs)], fs)
    assert trimmed.metadata == full.metadata
    assert trimmed.numpoints == int(len(pcm) - 1.7 * fs)
    assert abs(len(trimmed.time) - (len(full.time) - 1.7 * 25)) < 10
    # dims identical -> cached compilation
    npcm = int(np.round(fs / 800 * 0.75)) - 2
    unit = int(BUCKET_SECONDS * fs)
    n1 = int(np.ceil(len(pcm) / unit)) * unit
    n2 = int(np.ceil((len(pcm) - 1.7 * fs) / unit)) * unit
    assert n1 == n2
    assert EngineDims.for_waveform(n1, fs, 800, npcm) == \
        EngineDims.for_waveform(n2, fs, 800, npcm)


@pytest.mark.slow
def test_tpu_engine_timerange(default_drop_wav):
    """-s/-e trimming through decode_wav_tpu (raw int16 path)."""
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    wav, truth = default_drop_wav
    res = decode_wav_tpu(wav, timerange=[0, 45])
    assert res.numpoints == int(45 * 44100)
    assert res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert len(res.time) > 100


@pytest.mark.slow
def test_trigger_timeout_ignores_bucket_padding():
    """The fixed-compat hard-timeout trigger compares against the last
    *real* power window; the zero-padded bucket tail must not satisfy it
    (a 16 s file with an 18 s timeout stays status 1 even though its
    padded grid reaches 30 s)."""
    from axctdprocessor_tpu.models import simulator, tpu_engine
    from axctdprocessor_tpu.utils.config import DecoderConfig

    spec = simulator.SimSpec(duration=16.0, profile_start=200.0,
                             tone7500_amp=0.0, seed=5)
    pcm, _ = simulator.synthesize(spec)
    pcm = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    cfg = DecoderConfig(trigger_range=(5, 14), compat="fixed")
    res = tpu_engine.decode_waveform_tpu(pcm, 44100, config=cfg)
    # pulse at ~1 s, timeout at ~15 s > 16 s file's last window minus
    # pulse: the real grid ends at 16 s, which is past 1 s + 14 s, so the
    # timeout *does* fire on real windows
    assert res.status == 2

    cfg2 = DecoderConfig(trigger_range=(5, 18), compat="fixed")
    res2 = tpu_engine.decode_waveform_tpu(pcm, 44100, config=cfg2)
    # 1 s + 18 s = 19 s is beyond the real 16 s grid; only the padded
    # (30 s bucket) grid could satisfy it -> must stay status 1
    assert res2.status == 1


@pytest.mark.slow  # ~145 s: compiles two 16 s-bucket programs just for
# the fs-type quirk; the quirk itself is also covered by report goldens
def test_fs_report_type_preserved():
    """The report prints fs verbatim: float fs (post-decimation) must
    stay float through the fused engine, int fs must stay int."""
    from axctdprocessor_tpu.models import simulator, tpu_engine

    spec = simulator.SimSpec(duration=16.0, seed=6)
    pcm, _ = simulator.synthesize(spec)
    pcm = (pcm - np.mean(pcm)) / np.max(np.abs(pcm))
    res_f = tpu_engine.decode_waveform_tpu(pcm, 44100.0)
    res_i = tpu_engine.decode_waveform_tpu(pcm, 44100)
    assert isinstance(res_f.fs, float) and f"{res_f.fs}" == "44100.0"
    assert isinstance(res_i.fs, int) and f"{res_i.fs}" == "44100"


def test_trigger_core_matches_host(rng):
    """Device trigger (exact integer window thresholds) must reproduce
    the host trigger_scalars over random series and configs."""
    import jax.numpy as jnp
    from axctdprocessor_tpu.models import tpu_engine as eng
    from axctdprocessor_tpu.utils.config import DecoderConfig

    fs = 44100.0
    d_pcm = int(round(fs / 25))
    n_power = int(fs / 10)
    for trial in range(40):
        n_win = int(rng.integers(30, 500))
        r400 = rng.normal(1.2, 0.9, n_win).astype(np.float32)
        r7500 = rng.normal(0.8, 1.0, n_win).astype(np.float32)
        if trial % 4 == 0:
            r400 -= 10.0  # no pulse at all
        if trial % 3 == 0:
            r7500[:] = np.nan  # no usable baseline -> timeout path
        cfg = DecoderConfig(
            trigger_range=(float(rng.integers(0, 12)),
                           float(rng.choice([-1.0, 3.0, 7.5]))),
            compat="fixed" if trial % 2 else "strict")
        n = n_power + d_pcm * n_win  # yields exactly n_win real windows
        dims = eng.EngineDims.for_waveform(n, fs, 800, 39)
        host = eng.trigger_scalars(r400.astype(np.float64),
                                   r7500.astype(np.float64), cfg, fs, d_pcm,
                                   n_valid=n)
        trig_i, trig_f = eng.trigger_tables(cfg, fs)
        fp, mean, prof = eng.trigger_core(
            jnp.asarray(r400), jnp.asarray(r7500), jnp.asarray(n, jnp.int32),
            jnp.asarray(trig_i), jnp.asarray(trig_f), dims, fs)
        assert int(fp) == host[0], trial
        assert int(prof) == host[2], trial
        if np.isnan(host[1]):
            assert np.isnan(float(mean)), trial
        else:
            assert abs(float(mean) - host[1]) < 1e-5, trial


def test_trigger_timeout_truncation_boundary():
    """Non-integer tr1*fs: the timeout reach test truncates (reference
    AXCTDprocessor.py:404-405 uses int(fs*tr1) for both the reach and
    the offset).  The last real window sits exactly at
    firstpulse + int(tr1*fs), so truncation-vs-ceil semantics decide
    whether the timeout fires — a ceil'd reach fires one window late."""
    import jax.numpy as jnp
    from axctdprocessor_tpu.models import tpu_engine as eng
    from axctdprocessor_tpu.utils.config import DecoderConfig

    fs = 44100.0
    d_pcm = int(round(fs / 25))
    n_power = int(fs / 10)
    k = 40
    n_win = k + 1                       # windows 0..k; last_rel = k*d_pcm
    r400 = np.full(n_win, 3.0)          # pulse at window 0
    r7500 = np.full(n_win, np.nan)      # no baseline -> timeout path
    tr1 = (k * d_pcm + 0.5) / fs        # int(tr1*fs) == k*d_pcm, non-integer
    cfg = DecoderConfig(trigger_range=(0.0, tr1))
    n = n_power + d_pcm * n_win
    host = eng.trigger_scalars(r400, r7500, cfg, fs, d_pcm, n_valid=n)
    assert host[0] == 0
    assert host[2] == k * d_pcm, "timeout must fire at the int() boundary"

    dims = eng.EngineDims.for_waveform(n, fs, 800, 39)
    trig_i, trig_f = eng.trigger_tables(cfg, fs)
    fp, _, prof = eng.trigger_core(
        jnp.asarray(r400, jnp.float32), jnp.asarray(r7500, jnp.float32),
        jnp.asarray(n, jnp.int32), jnp.asarray(trig_i),
        jnp.asarray(trig_f), dims, fs)
    assert int(fp) == host[0]
    assert int(prof) == host[2]


@pytest.mark.slow
def test_lowrate_16k_decode_vs_parity():
    """16 kHz is a legal rate (7.5 kHz tone under Nyquist) whose
    crossings sit ~6 samples apart — denser than a 128-lane row can
    hold under the 44.1 kHz rowcap.  The fs-scaled cap
    (chain.rowcap_for_fs) must keep the decode lossless: no overflow
    flag and near-full frame agreement with the parity engine."""
    from collections import Counter

    from axctdprocessor_tpu.models import simulator
    from axctdprocessor_tpu.models.parity_engine import decode_waveform

    spec = simulator.SimSpec(fs=16000, duration=45.0, profile_start=33.0,
                             seed=5)
    pcm, truth = simulator.synthesize(spec)
    raw = np.round(pcm * 24000 / np.max(np.abs(pcm))).astype(np.int16)
    ref = decode_waveform(raw.astype(np.float64), 16000)
    res = decode_waveform_tpu(raw, 16000, wire="int16")
    assert ref.status == res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert res.overflow == 0
    ca, cb = Counter(ref.hexframes), Counter(res.hexframes)
    agree = sum((ca & cb).values()) / max(sum((ca | cb).values()), 1)
    assert agree >= 0.98


@pytest.mark.slow
def test_highrate_device_decimation(tmp_path):
    """An 88.2 kHz int16 WAV decodes through the raw device path
    (conditioning + zero-phase decimation on device) and matches the
    host scipy-decimated float path."""
    from axctdprocessor_tpu.models import simulator
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    spec = simulator.SimSpec(fs=88200, duration=42.0, profile_start=33.0,
                             seed=31)
    pcm, truth = simulator.synthesize(spec)
    wav = str(tmp_path / "hi.wav")
    simulator.write_wav(wav, pcm, spec.fs)

    res = decode_wav_tpu(wav)  # raw int16 + device decimation
    assert res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert isinstance(res.fs, float) and res.fs == 44100.0
    assert res.numpoints == (int(42.0 * 88200) + 1) // 2

    host_pcm, host_fs = read_wav(wav)  # scipy decimate path
    assert host_fs == 44100.0
    ref = decode_waveform_tpu(host_pcm, host_fs)
    assert ref.metadata == res.metadata
    a, b = set(res.hexframes), set(ref.hexframes)
    assert len(a & b) / max(len(a | b), 1) > 0.98


def test_packed_result_roundtrip(engines):
    """The single-vector result packing (back_half_core -> unpack_result)
    must preserve the 2-decimal contract exactly: every reported value is
    an integer number of centi-units, flags survive, and hex frames are
    bit-exact (they ride the buffer as bitcast uint32)."""
    _, fast, truth = engines
    for vals in (fast.time, fast.depth, fast.temperature,
                 fast.conductivity, fast.salinity, fast.r400, fast.r7500):
        arr = np.asarray(vals)
        arr = arr[~np.isnan(arr)]
        assert np.allclose(arr * 100, np.round(arr * 100), atol=1e-6)
    assert len(fast.hexframes_qc) == len(fast.time)
    assert all(len(h) == 8 and int(h, 16) >= 0 for h in fast.hexframes[:50])


def test_header_windows_span_semantics():
    """stage15's searchsorted window spans must match the old masked
    compaction: bits outside [lo, hi] or past n_edges-1 are excluded,
    empty/inverted windows give zero counts."""
    import jax.numpy as jnp

    from axctdprocessor_tpu.models import tpu_engine as eng
    from axctdprocessor_tpu.utils.config import DecoderConfig

    cfg = DecoderConfig()
    fs = 44100.0
    npcm = int(np.round(fs / cfg.bitrate * 0.75)) - 2 * cfg.bit_inset
    dims = eng.EngineDims.for_waveform(int(15 * fs), fs, cfg.bitrate, npcm)
    me = dims.max_edges
    rng = np.random.default_rng(3)
    n_edges = 5000
    edges = np.full(me, int(15 * fs), np.int64)
    edges[:n_edges] = np.sort(rng.choice(int(14 * fs), n_edges, False))
    s1 = rng.random(me).astype(np.float32) + 0.2
    s2 = rng.random(me).astype(np.float32) + 0.2
    c0 = s2 / np.maximum(s1, 1e-30)  # the single confidence-ratio stream
    for lo, hi in ((edges[100], edges[700]), (0, 50), (10**9, 2 * 10**9),
                   (2**30, -2**30)):  # normal, pre-data, post-data, inverted
        hb = np.asarray([lo, hi, lo, hi, lo, hi], np.int64)
        out = eng.stage15_core(
            jnp.asarray(c0), jnp.asarray(edges),
            jnp.asarray(n_edges), jnp.asarray(hb),
            jnp.asarray(0, jnp.int32), dims)
        sel = (np.arange(me) < n_edges - 1) & (edges >= lo) & (edges <= hi)
        assert int(out["h2_n"]) == int(sel.sum())
        bits_host = np.asarray(out["bits"])
        got = np.asarray(out["h2_bits"])[: sel.sum()]
        assert np.array_equal(got, bits_host[sel][: len(got)])
