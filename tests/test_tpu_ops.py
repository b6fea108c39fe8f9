"""Unit tests for the device core ops (run on CPU in x64 for exactness)."""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy import signal as sg

from axctdprocessor_tpu.ops import chain, goertzel, iir


def test_sosfilt_scan_matches_scipy(rng):
    x = rng.standard_normal(5000)
    sos = iir.design_sos(44100.0, use_bandpass=False)
    ref = sg.sosfilt(sos, x)
    mine = np.asarray(iir.sosfilt_scan(sos, jnp.asarray(x)))
    # XLA fuses FMAs, so bitwise equality with scipy is unattainable even
    # for the identical-op-order scan; this is why the byte-parity engine
    # filters on host.  Demand tight f64 agreement instead.
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-12)


def test_sosfilt_parallel_matches_scipy():
    x = np.random.default_rng(7).standard_normal(20000)
    for bp in (False, True):
        sos = iir.design_sos(44100.0, use_bandpass=bp)
        ref = sg.sosfilt(sos, x)
        mine = np.asarray(iir.sosfilt(sos, jnp.asarray(x)))
        # parallel evaluation reorders float ops; demand near-f64 agreement
        np.testing.assert_allclose(mine, ref, rtol=1e-7, atol=1e-10)


def test_boxsmooth_matches_host(rng):
    x = np.abs(rng.standard_normal(500))
    mine = np.asarray(iir.boxsmooth_lag(jnp.asarray(x), 5))
    expected = np.array(
        [np.mean(x[max(0, i - 5) : i + 1]) for i in range(len(x))]
    )
    np.testing.assert_allclose(mine, expected, rtol=1e-12)


def test_framed_tone_power_matches_reference_loop(rng):
    fs = 44100.0
    x = rng.standard_normal(int(fs * 1.5))
    window, stride = int(fs / 10), int(round(fs / 25))
    freqs = [400.0, 7500.0, 3000.0]
    trig = goertzel.tone_matrix(window, freqs, fs)
    mine = np.asarray(goertzel.framed_tone_power(jnp.asarray(x), window, stride, trig))
    # reference-style loop
    for w_i, start in enumerate(range(0, len(x) - window, stride)):
        cdata = x[start : start + window]
        for f_i, f in enumerate(freqs):
            theta = 2 * np.pi * np.arange(window) / fs * f
            expected = np.abs(np.sum(cdata * np.cos(theta) + 1j * cdata * np.sin(theta)))
            assert abs(mine[w_i, f_i] - expected) < 1e-6 * max(expected, 1.0)


def test_tone_power_at(rng):
    fs = 44100.0
    x = rng.standard_normal(4000)
    trig = goertzel.tone_matrix(39, [400.0, 800.0], fs)
    starts = np.array([0, 100, 512, 3000])
    mine = np.asarray(goertzel.tone_power_at(jnp.asarray(x), jnp.asarray(starts), 39, trig))
    for i, s in enumerate(starts):
        w = x[s : s + 39]
        for j, f in enumerate([400.0, 800.0]):
            theta = 2 * np.pi * np.arange(39) / fs * f
            expected = np.abs(np.sum(w * np.cos(theta) + 1j * w * np.sin(theta)))
            np.testing.assert_allclose(mine[i, j], expected, rtol=1e-9)


def _host_edge_chain(zc, fs, bitrate):
    """The reference's greedy chain (demodulate.py:85-93), for comparison."""
    edges = [zc[0]]
    c = 0
    while c < len(zc) - 5:
        options = zc[c + 1 : c + 5]
        c += 1 + int(np.argmin(np.abs(options - (zc[c] + fs / bitrate))))
        edges.append(zc[c])
    return edges


@pytest.mark.slow
def test_bit_edge_chain_matches_host(rng):
    fs, bitrate = 44100.0, 800.0
    for trial in range(8):
        # synthetic crossing pattern: mostly ~55 apart with mid-bit extras
        n = 400
        gaps = rng.choice([27, 28, 55, 56, 41], size=n, p=[0.2, 0.2, 0.3, 0.2, 0.1])
        zc = np.cumsum(gaps) + 100
        expected = _host_edge_chain(zc, fs, bitrate)

        m = len(zc) + 64
        padded = np.full(m, np.iinfo(np.int32).max // 2, dtype=np.int64)
        padded[: len(zc)] = zc
        edges_idx, n_edges = chain.enumerate_bit_edges(
            jnp.asarray(padded), len(zc), fs, bitrate, max_edges=m
        )
        n_edges = int(n_edges)
        got = np.asarray(padded)[np.asarray(edges_idx[:n_edges])]
        assert n_edges == len(expected), trial
        np.testing.assert_array_equal(got, expected)


def test_frame_sync_accept_overflow_degrades_gracefully():
    """Accepts beyond the n/16 compaction capacity truncate the walk —
    but every emitted frame must still respect the 32-bit spacing and
    match the host walk up to the truncation point (the overflow guard;
    an unbounded searchsorted result used to slip through and emit a
    frame violating the spacing invariant)."""
    n = 4096
    accept = np.zeros(n, bool)
    accept[::2] = True  # far denser than the n/16 capacity
    starts, n_frames, _, overflow = chain.enumerate_frames(
        jnp.asarray(accept), n, max_steps=n, max_frames=256)
    got = np.asarray(starts[: int(n_frames)])
    assert int(n_frames) > 0
    assert int(overflow) & 1  # the truncation is signalled, not silent
    assert np.all(np.diff(got) >= 32)
    # prefix matches the host walk
    s, ref = 0, []
    while s < n - 32 and len(ref) < len(got):
        if accept[s]:
            ref.append(s)
            s += 32
        else:
            s += 1
    np.testing.assert_array_equal(got, ref[: len(got)])


def test_frame_sync_chain_matches_host(rng):
    for trial in range(8):
        n = 2000
        accept = rng.random(n) < 0.06
        # host reference walk
        s, starts_ref = 0, []
        while s < n - 32:
            if accept[s]:
                starts_ref.append(s)
                s += 32
            else:
                s += 1
        starts, n_frames, consumed, overflow = chain.enumerate_frames(
            jnp.asarray(accept), n, max_steps=n, max_frames=256
        )
        assert int(consumed) == s, trial
        assert int(overflow) == 0, trial  # clean walk signals no overflow
        assert int(n_frames) == len(starts_ref)
        np.testing.assert_array_equal(
            np.asarray(starts[: len(starts_ref)]), starts_ref
        )


def test_framed_tone_power_tiled_matches_gather(rng):
    fs = 44100.0
    x = rng.standard_normal(int(fs * 2.3))
    window, stride = int(fs / 10), int(round(fs / 25))
    trig = goertzel.tone_matrix(window, [400.0, 7500.0, 3000.0], fs)
    a = np.asarray(goertzel.framed_tone_power(jnp.asarray(x), window, stride, trig))
    b = np.asarray(goertzel.framed_tone_power_tiled(jnp.asarray(x), window, stride, trig))
    assert a.shape == b.shape
    # identical except possibly the last windows (zero-pad vs clamp)
    np.testing.assert_allclose(a[:-2], b[:-2], rtol=1e-9, atol=1e-9)


def test_sosfilt_fft_matches_scipy_steady_state():
    x = np.random.default_rng(3).standard_normal(60000)
    for bp in (False, True):
        sos = iir.design_sos(44100.0, use_bandpass=bp)
        ref = sg.sosfilt(sos, x)
        mine = np.asarray(iir.sosfilt_fft(sos, jnp.asarray(x)))
        # transient differs only within ~the impulse-response length
        np.testing.assert_allclose(mine[3000:], ref[3000:], rtol=1e-6, atol=1e-8)


def test_chain_enumerate_level_cap(rng):
    """Capped-level doubling (sliding-window tail fill) must equal the
    uncapped chain for arbitrary advancing successor tables."""
    import jax.numpy as jnp

    for trial in range(6):
        m = int(rng.integers(300, 4000))
        nxt = np.minimum(np.arange(m) + rng.integers(1, 5, m), m - 1)
        nxt[-1] = m - 1
        k = int(rng.integers(50, 2 * m))
        full = chain.chain_enumerate(jnp.asarray(nxt), 0, k, max_level=32)
        for P in (2, 5, 8):
            capped = chain.chain_enumerate(jnp.asarray(nxt), 0, k, max_level=P)
            np.testing.assert_array_equal(np.asarray(full), np.asarray(capped),
                                          err_msg=f"trial {trial} P={P}")


def test_compact_indices_matches_where(rng):
    import jax.numpy as jnp

    for trial in range(6):
        n = int(rng.integers(100, 5000))
        mask = rng.random(n) < rng.choice([0.01, 0.2, 0.9])
        size = int(rng.integers(8, n))
        fill = 2 ** 30
        want = np.asarray(jnp.where(jnp.asarray(mask), size=size,
                                    fill_value=fill)[0])
        got, cnt = chain.compact_indices(jnp.asarray(mask), size, fill)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(trial))
        assert int(cnt) == int(mask.sum())


def test_compact_indices_rowcap_low_fs_spacing(rng):
    """Rowcap compaction must not truncate crossings at low sample
    rates: a 16 kHz recording's crossings can sit ~6 samples apart
    (>16 per 128-lane row), which the 44.1 kHz default cap would drop.
    rowcap_for_fs must size the cap so such masks compact exactly."""
    import jax.numpy as jnp

    for fs, min_gap in ((44100.0, 17), (22050.0, 9), (16000.0, 6)):
        cap = chain.rowcap_for_fs(fs)
        n = 20000
        # densest legal mask: a crossing every min_gap samples
        mask = np.zeros(n, bool)
        mask[::min_gap] = True
        size = int(mask.sum()) + 64
        fill = 2 ** 30
        want = np.asarray(jnp.where(jnp.asarray(mask), size=size,
                                    fill_value=fill)[0])
        got, cnt, rovf = chain.compact_indices_rowcap(
            jnp.asarray(mask), size, fill, row_cap=cap)
        np.testing.assert_array_equal(np.asarray(got), want,
                                      err_msg=f"fs={fs}")
        assert int(cnt) == int(mask.sum())
        assert int(rovf) == 0, f"fs={fs}: spurious row overflow"
    # and the flag fires when a row genuinely exceeds the cap
    dense = np.ones(256, bool)
    _, _, rovf = chain.compact_indices_rowcap(
        jnp.asarray(dense), 300, 2 ** 30, row_cap=16)
    assert int(rovf) == 1
