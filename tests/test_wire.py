"""int8 host->device wire format (ops.wire) — quantization + decode parity.

The int8 wire halves (vs int16) the host->device upload bytes.  Decode
must be unaffected: the
pipeline is scale-invariant and device conditioning re-removes DC, so an
int8-quantized drop decodes to the same frames as the int16 original.
"""

import numpy as np
import pytest

from axctdprocessor_tpu.ops import wire
from axctdprocessor_tpu.models import segmented, simulator
from axctdprocessor_tpu.models.tpu_engine import decode_waveform_tpu
from axctdprocessor_tpu.utils.wavio import read_wav_raw16


def frame_agreement(a, b) -> float:
    """Multiset Jaccard agreement between two hexframe lists.

    Positional zip comparison collapses to ~0 when one borderline frame
    is inserted/dropped early (every later position shifts); the
    multiset form measures actual decode agreement."""
    from collections import Counter

    ca, cb = Counter(a), Counter(b)
    return sum((ca & cb).values()) / max(sum((ca | cb).values()), 1)


@pytest.fixture(scope="module")
def noisy_int16():
    """A noisy 70 s drop as int16 (borderline bits stress quantization)."""
    spec = simulator.SimSpec(duration=70.0, profile_start=33.0, seed=57)
    pcm, truth = simulator.synthesize(spec)
    rng = np.random.default_rng(3)
    raw = np.clip(
        np.round(pcm * 24000 / np.max(np.abs(pcm)))
        + rng.integers(-250, 250, len(pcm)),
        -32768, 32767).astype(np.int16)
    return raw, truth


def test_quantize_int8_properties(rng):
    x = (rng.standard_normal(100000) * 12000).astype(np.int16)
    x[:100] = 0  # padding region stays exactly zero
    q = wire.quantize_int8(x)
    assert q.dtype == np.int8
    assert np.all(np.abs(q.astype(np.int32)) <= 127)
    assert np.max(np.abs(q)) == 127  # peak maps to full scale
    assert np.all(q[:100] == 0)
    # quantization error bounded by half an lsb of the int8 grid
    # (peak via int32: np.abs wraps at int16 -32768)
    scale = np.max(np.abs(x.astype(np.int32))) / 127.0
    err = x.astype(np.float64) - q.astype(np.float64) * scale
    assert np.max(np.abs(err)) <= 0.5 * scale + 1e-9
    # int8 input passes through untouched
    assert wire.quantize_int8(q) is q


def test_native_quantizers_match_numpy(rng):
    """C quantizers (the int16 fast path) bit-match the numpy formula,
    including the int16 minimum where np.abs wraps."""
    from axctdprocessor_tpu.utils import native

    if native.get_library() is None:
        pytest.skip("no native toolchain")
    x = (rng.standard_normal(30011) * 15000).astype(np.int16)
    x[0], x[1] = -32768, 32767  # peak must resolve to 32768, not wrap
    peak = float(np.max(np.abs(x.astype(np.int32))))
    ref8 = np.rint(np.multiply(x, np.float32(127.0 / peak),
                               dtype=np.float32)).astype(np.int8)
    np.testing.assert_array_equal(native.quantize_int8_native(x), ref8)
    q4 = (np.clip(np.rint(np.multiply(x, np.float32(7.0 / peak),
                                      dtype=np.float32)), -7, 7) + 8
          ).astype(np.uint8)
    q4 = np.concatenate([q4, np.asarray([8], np.uint8)])  # odd length
    ref4 = (q4[0::2] << 4) | q4[1::2]
    np.testing.assert_array_equal(native.quantize_int4_native(x), ref4)


def test_encode_rows_per_row_scale():
    rows = np.stack([
        np.asarray([0, 1000, -2000, 0], np.int16),
        np.asarray([0, 30000, 15000, -30000], np.int16),
    ])
    q = wire.quantize_int8_rows(rows)
    assert q.dtype == np.int8
    # each row quantizes at its own peak
    assert q[0, 2] == -127 and q[1, 1] == 127
    assert q[0, 1] == round(1000 * 127 / 2000)
    # zero padding survives exactly
    assert q[0, 0] == 0 and q[0, 3] == 0


def test_resolve_wire():
    assert wire.resolve_wire("int16", np.int16) == "int16"
    assert wire.resolve_wire("int8", np.int16) == "int8"
    # floats never re-encode
    assert wire.resolve_wire("int8", np.float32) == "int16"
    # auto resolves to a concrete format
    assert wire.resolve_wire("auto", np.int16) in ("int4", "int8", "int16")
    assert wire.resolve_wire("int4", np.int16) == "int4"
    with pytest.raises(ValueError):
        wire.resolve_wire("int2", np.int16)


@pytest.mark.slow
def test_int8_wire_decode_matches_int16(noisy_int16):
    raw, truth = noisy_int16
    r16 = decode_waveform_tpu(raw, 44100, wire="int16")
    r8 = decode_waveform_tpu(raw, 44100, wire="int8")
    assert r8.status == r16.status == 2
    assert r8.metadata == r16.metadata
    assert r8.metadata["serial_no"] == truth["serial_no"]
    assert r8.firstpulse400 == r16.firstpulse400
    assert r8.profstartind == r16.profstartind
    h16, h8 = r16.hexframes, r8.hexframes
    agree = sum(a == b for a, b in zip(h16, h8))
    assert agree >= 0.995 * max(len(h16), len(h8))
    assert abs(len(r8.time) - len(r16.time)) <= 3


@pytest.mark.slow
def test_int8_wire_segmented(noisy_int16):
    raw, truth = noisy_int16
    r16 = segmented.decode_waveform_segmented(raw, 44100, wire="int16")
    r8 = segmented.decode_waveform_segmented(raw, 44100, wire="int8")
    assert r8.status == 2
    assert r8.metadata == r16.metadata
    h16, h8 = r16.hexframes, r8.hexframes
    agree = sum(a == b for a, b in zip(h16, h8))
    assert agree >= 0.995 * max(len(h16), len(h8))


@pytest.mark.slow
def test_int8_wire_batch(noisy_int16):
    from axctdprocessor_tpu.parallel.batch import decode_batch

    raw, truth = noisy_int16
    batch = np.stack([raw, raw])
    r16 = decode_batch(batch, 44100, wire="int16")
    r8 = decode_batch(batch, 44100, wire="int8")
    for a, b in zip(r8, r16):
        assert a.status == b.status == 2
        assert a.metadata == b.metadata
        agree = sum(x == y for x, y in zip(a.hexframes, b.hexframes))
        assert agree >= 0.995 * max(len(a.hexframes), len(b.hexframes))


def test_int4_pack_unpack_roundtrip(rng):
    from axctdprocessor_tpu.models.tpu_engine import unpack_int4
    import jax.numpy as jnp

    for n in (10, 11, 100001):
        x = (rng.standard_normal(n) * 9000).astype(np.int16)
        packed = wire.quantize_int4_packed(x)
        assert packed.dtype == np.uint8 and len(packed) == (n + 1) // 2
        got = np.asarray(unpack_int4(jnp.asarray(packed), n))
        peak = np.max(np.abs(x))
        want = np.clip(np.rint(x * 7.0 / peak), -7, 7)
        # the C encoder noise-shapes: each level may differ from plain
        # rounding by the carried error (|e| <= 1 -> at most one step,
        # two at a clipped peak); the numpy fallback rounds plainly
        assert np.max(np.abs(got - want)) <= 2
        assert np.mean(np.abs(got - want)) < 0.6
        dc, pk = wire.int4_stats(packed, n)
        unpacked = got.astype(np.float64)
        assert dc == pytest.approx(float(np.mean(unpacked)), abs=1e-12)
        assert pk == max(float(np.max(np.abs(unpacked))), 1.0)


def test_int4_noise_shaping_in_band():
    """The C int4 encoder's error feedback must (a) bit-match a scalar
    reference loop and (b) cut the demod-band (300-1300 Hz) quantization
    noise vs plain rounding by >= 6 dB on a realistic FSK-plus-tone mix
    (measured ~17 dB; the loose floor keeps the test robust)."""
    from axctdprocessor_tpu.utils import native

    if native.get_library() is None:
        pytest.skip("no native toolchain")
    fs = 44100
    t = np.arange(4 * fs) / fs
    sig = (0.5 * np.sin(2 * np.pi * 400 * t)
           + 0.3 * np.sin(2 * np.pi * 800 * t)
           + 0.2 * np.sin(2 * np.pi * 7500 * t))
    x = np.round(sig / np.max(np.abs(sig)) * 28000).astype(np.int16)

    # scalar reference of the C loop (wavio.cpp axctd_quantize_int4_ns)
    peak = np.float32(float(np.max(np.abs(x.astype(np.int32)))))
    scale = np.float32(7.0 / float(peak))
    C = np.float32(12582912.0)
    e = np.float32(0.0)
    ref = np.empty(512, np.int32)
    for i in range(512):
        v = np.float32(np.float32(x[i]) * scale + e)
        q = np.float32(v + C) - C
        q = min(max(q, np.float32(-7.0)), np.float32(7.0))
        e = min(max(np.float32(v - q), np.float32(-1.0)), np.float32(1.0))
        ref[i] = int(q)
    packed = native.quantize_int4_ns_native(x)
    u = np.empty(len(x), np.int32)
    u[0::2] = (packed.astype(np.int32) >> 4) - 8
    u[1::2] = (packed.astype(np.int32) & 15) - 8
    np.testing.assert_array_equal(u[:512], ref)

    def band_err(unpacked):
        err = unpacked - x / (float(peak) / 7.0)
        E = np.abs(np.fft.rfft(err)) ** 2
        f = np.fft.rfftfreq(len(err), 1 / fs)
        return float(np.sum(E[(f >= 300) & (f <= 1300)]))

    plain = native.quantize_int4_native(x)
    up = np.empty(len(x), np.int32)
    up[0::2] = (plain.astype(np.int32) >> 4) - 8
    up[1::2] = (plain.astype(np.int32) & 15) - 8
    assert band_err(u) < band_err(up) / 4.0  # >= 6 dB better in-band


def test_chunked_int4_encoder_matches_oneshot(rng):
    """The segmented path's chunked encoder must be byte-identical to
    the whole-waveform C pass under arbitrary ensure() patterns, and its
    closed-form dc must sit within the final-carried-error/n bound of
    the exact packed-stream statistics."""
    from axctdprocessor_tpu.utils import native

    if native.get_library() is None:
        pytest.skip("no native toolchain")
    for n in (101, 30011, 400001):
        x = (rng.standard_normal(n) * 12000).astype(np.int16)
        x[min(5, n - 1)] = -32768  # peak must widen, not wrap
        ref = wire.quantize_int4_packed(x)
        enc = wire.chunked_int4_encoder(x)
        for tgt in list(range(0, n, max(n // 7, 1))) + [n - 1, n, n + 50]:
            enc.ensure(tgt + 3)
        np.testing.assert_array_equal(enc.packed, ref)
        dc_exact, pk_exact = wire.int4_stats(ref, n)
        assert abs(enc.dc - dc_exact) <= 2.0 / n + 1e-9
        assert enc.peak == 7.0 and pk_exact == 7.0


@pytest.mark.slow
def test_int4_wire_decode(default_drop_wav):
    """Opt-in int4 wire on a clean drop: same metadata, ~same frames."""
    wav, truth = default_drop_wav
    raw, fs = read_wav_raw16(wav)
    r16 = decode_waveform_tpu(raw, fs, wire="int16")
    r4 = decode_waveform_tpu(raw, fs, wire="int4")
    assert r4.status == 2
    assert r4.metadata == r16.metadata
    assert r4.metadata["serial_no"] == truth["serial_no"]
    assert frame_agreement(r16.hexframes, r4.hexframes) >= 0.98

    s4 = segmented.decode_waveform_segmented(raw, fs, wire="int4")
    assert s4.status == 2 and s4.metadata["serial_no"] == truth["serial_no"]
    assert frame_agreement(s4.hexframes, r4.hexframes) >= 0.98


@pytest.mark.slow
def test_int4_wire_batch_and_pipeline(noisy_int16):
    from axctdprocessor_tpu.parallel.batch import decode_batch
    from axctdprocessor_tpu.parallel.pipeline import decode_batches_pipelined

    raw, truth = noisy_int16
    batch = np.stack([raw, raw])
    r16 = decode_batch(batch, 44100, wire="int16")
    r4 = decode_batch(batch, 44100, wire="int4")
    for a, b in zip(r4, r16):
        assert a.status == b.status == 2
        assert a.metadata == b.metadata
        assert frame_agreement(a.hexframes, b.hexframes) >= 0.95

    # the pipelined path (stage1 + back half) computes the same ops as
    # the fused program: int4 results must match decode_batch exactly
    piped = decode_batches_pipelined([(batch, None)], 44100, wire="int4")
    for a, b in zip(piped[0], r4):
        assert a.hexframes == b.hexframes
        assert a.metadata == b.metadata


@pytest.mark.slow  # ~190 s: odd-bucket padding edge; odd_length covers odd semantics in the fast set
def test_int4_wire_odd_bucket(rng):
    """fs = 11025 makes the 15 s pad bucket odd (165375 samples): the
    packed layout must force an even padded count, not floor it."""
    noise = (rng.standard_normal(10 * 11025) * 5000).astype(np.int16)
    res = decode_waveform_tpu(noise, 11025, wire="int4")
    assert res.status == 0  # pure noise: no pulse; shapes must not crash


def test_int4_wire_odd_length(default_drop_wav):
    """An odd sample count exercises the trailing pad nibble.

    Deliberately reuses the default drop's pad bucket: the odd slice then
    hits the int4 program test_int4_wire_decode already compiled.  (With
    a fresh 75 s-bucket program here instead, XLA's CPU compiler
    segfaulted DETERMINISTICALLY — 3/3 runs, jax 0.8 era — when >100
    tests of state preceded it, while the same compile succeeds in a
    fresher process; the coverage target is the pad nibble, not another
    compile, so we avoid the landmine.)"""
    wav, truth = default_drop_wav
    raw, fs = read_wav_raw16(wav)
    res = decode_waveform_tpu(raw[:-1], fs, wire="int4")
    assert res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert res.numpoints == len(raw) - 1


@pytest.mark.slow
def test_wav_raw16_through_int8_wire(default_drop_wav):
    """decode_wav_tpu's raw read + explicit int8 wire preserves decode."""
    from axctdprocessor_tpu.models.tpu_engine import decode_wav_tpu

    wav, truth = default_drop_wav
    res = decode_wav_tpu(wav, wire="int8")
    ref = decode_wav_tpu(wav, wire="int16")
    assert res.status == 2
    assert res.metadata == ref.metadata
    assert res.metadata["serial_no"] == truth["serial_no"]
    agree = sum(a == b for a, b in zip(res.hexframes, ref.hexframes))
    assert agree >= 0.995 * max(len(res.hexframes), len(ref.hexframes))


def _cliff_rows(n_rows=3):
    """Rows from the bench's 64-drop batch config: row 2 deterministically
    collapses through the noise-shaped int4 wire (status 2 but ~30 frames
    and no serial — scripts/diagnose_int4_row.py)
    while rows 0-1 decode cleanly.  The canonical lossy-retry fixture."""
    rng = np.random.default_rng(7)
    spec = simulator.SimSpec(duration=60.0, profile_start=40.0, seed=21)
    pcm, truth = simulator.synthesize(spec)
    base = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    rows = np.stack([
        np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
        .astype(np.int16)
        for _ in range(n_rows)
    ])
    return rows, truth


def test_lossy_retry_predicate():
    """lossy_retry_worthy flags only collapsed int4-wire decodes."""
    from axctdprocessor_tpu.models.parity_engine import DecodeResult
    from axctdprocessor_tpu.models.tpu_engine import lossy_retry_worthy
    from axctdprocessor_tpu.utils.config import DecoderConfig

    cfg = DecoderConfig()
    n, fs = int(60 * 44100), 44100.0

    healthy = DecodeResult(fs=fs, numpoints=n, status=2, wire="int4")
    healthy.firstpointtime = 40.0
    healthy.hexframes = ["x"] * 460  # ~25/s over the 20 s profile
    assert not lossy_retry_worthy(healthy, n, fs, cfg)

    collapsed = DecodeResult(fs=fs, numpoints=n, status=2, wire="int4")
    collapsed.firstpointtime = 40.0
    collapsed.hexframes = ["x"] * 30
    assert lossy_retry_worthy(collapsed, n, fs, cfg)

    # same collapse through a lossless wire: genuine signal loss, no retry
    collapsed_int8 = DecodeResult(fs=fs, numpoints=n, status=2, wire="int8")
    collapsed_int8.firstpointtime = 40.0
    collapsed_int8.hexframes = ["x"] * 30
    assert not lossy_retry_worthy(collapsed_int8, n, fs, cfg)

    # an int4 decode that never triggered is worth one lossless check
    untriggered = DecodeResult(fs=fs, numpoints=n, status=0, wire="int4")
    assert lossy_retry_worthy(untriggered, n, fs, cfg)


@pytest.mark.slow
def test_int4_cliff_row_retries_lossless():
    """The known int4-ns cliff row decodes correctly via the auto retry."""
    rows, truth = _cliff_rows()
    row2 = rows[2]

    bad = decode_waveform_tpu(row2, 44100, wire="int4", mode="monolithic",
                              lossy_retry=False)
    assert bad.metadata["serial_no"] is None  # the cliff, unretried
    assert len(bad.hexframes) < 100

    good = decode_waveform_tpu(row2, 44100, wire="int4", mode="monolithic")
    assert good.status == 2
    assert good.wire == "int8"  # served by the lossless retry
    assert good.metadata["serial_no"] == truth["serial_no"]
    assert len(good.hexframes) > 400


@pytest.mark.slow
def test_int4_cliff_batch_retries_only_bad_rows():
    """decode_batch re-decodes the collapsed rows at int8, keeps the rest."""
    from axctdprocessor_tpu.parallel.batch import decode_batch

    rows, truth = _cliff_rows()
    res = decode_batch(rows, 44100, wire="int4")
    for r in res:
        assert r.status == 2
        assert r.metadata["serial_no"] == truth["serial_no"]
        assert len(r.hexframes) > 400
    assert res[2].wire == "int8"  # the cliff row, served by the retry
    assert res[0].wire == "int4" and res[1].wire == "int4"


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_default_wire_is_int16_on_every_backend(backend, monkeypatch):
    """"auto" resolves to int16 with no platform branch."""
    import jax

    from axctdprocessor_tpu.ops import wire

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert wire.default_wire() == "int16"
    assert wire.resolve_wire("auto", np.int16) == "int16"
