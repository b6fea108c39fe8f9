"""IIR filtering (Butterworth SOS cascade) on an accelerator.

The reference leans on scipy's C ``sosfilt`` (demodulate.py:74) — a
strictly sequential per-sample recurrence.  On an accelerator, a
sequential scan at 44.1 kHz x minutes is latency-poison, so this module
provides parallel implementations of the same direct-form-II-transposed
cascade:

* :func:`sosfilt_scan` — ``lax.scan`` with the exact per-sample update
  order scipy uses; bit-faithful in float64, used for cross-validation;
* :func:`sosfilt` — the parallel path: each biquad's state recurrence
  ``s[n] = A s[n-1] + B x[n]`` (A is 2x2) is evaluated with
  ``lax.associative_scan`` over affine-map composition — O(N) work,
  O(log N) depth.  Sections run in sequence (only 3 for the order-6
  designs used here).

Coefficients are designed host-side with scipy (the reference's own
design path, AXCTDprocessor.py:254-257) and passed in as arrays.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def design_sos(fs: float, use_bandpass: bool = False) -> np.ndarray:
    """Order-6 Butterworth SOS (100-1200 Hz bandpass or 1200 Hz lowpass)."""
    from scipy import signal

    if use_bandpass:
        return signal.butter(6, [100, 1200], btype="bandpass", fs=fs, output="sos")
    return signal.butter(6, 1200, btype="lowpass", fs=fs, output="sos")


def design_decim_sos(q: int = 2) -> np.ndarray:
    """Anti-alias filter of the reference's decimator, as SOS.

    scipy.signal.decimate's IIR default is ``cheby1(8, 0.05, 0.8/q)``
    applied zero-phase (reference AXCTDprocessor.py:60-62); the device
    decimator evaluates |H|^2 in the FFT domain instead of filtfilt.
    """
    from scipy import signal

    return signal.cheby1(8, 0.05, 0.8 / q, output="sos")


def _affine_combine(left, right):
    """Compose 2x2 affine maps held as six flat arrays (right after left).

    Six flat (N,) arrays instead of (N, 2, 2) matrices: no tiny trailing
    dimensions for the compiler to lay out on long waveforms.
    """
    l11, l12, l21, l22, lc1, lc2 = left
    r11, r12, r21, r22, rc1, rc2 = right
    return (
        r11 * l11 + r12 * l21,
        r11 * l12 + r12 * l22,
        r21 * l11 + r22 * l21,
        r21 * l12 + r22 * l22,
        r11 * lc1 + r12 * lc2 + rc1,
        r21 * lc1 + r22 * lc2 + rc2,
    )


def _biquad_parallel(x, coeffs):
    """One DFII-t biquad via associative scan over its state recurrence.

    State s = (z1, z2):
      y[n]  = b0 x[n] + z1[n-1]
      z1[n] = (b1 - a1 b0) x[n] - a1 z1[n-1] + z2[n-1]
      z2[n] = (b2 - a2 b0) x[n] - a2 z1[n-1]
    i.e. s[n] = A s[n-1] + B x[n] with constant A = [[-a1, 1], [-a2, 0]].
    """
    b0, b1, b2, a1, a2 = coeffs
    n = x.shape[0]
    dt = x.dtype
    ones = jnp.ones((n,), dt)
    zeros = jnp.zeros((n,), dt)
    elems = (
        -a1 * ones, ones, -a2 * ones, zeros,
        (b1 - a1 * b0) * x, (b2 - a2 * b0) * x,
    )
    out = lax.associative_scan(_affine_combine, elems, axis=0)
    z1 = out[4]
    z1_prev = jnp.concatenate([jnp.zeros((1,), dt), z1[:-1]])
    return b0 * x + z1_prev


def sosfilt(sos, x: jnp.ndarray) -> jnp.ndarray:
    """Parallel SOS cascade (zero initial state).

    Accepts host coefficients or a traced (n_sections, 6) array."""
    sos = jnp.asarray(sos, dtype=x.dtype)
    y = x
    for sec in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (sos[sec, j] for j in range(6))
        y = _biquad_parallel(y, (b0, b1, b2, a1, a2))
    return y


def sos_freq_response(sos, nfft: int) -> np.ndarray:
    """Exact frequency response of the SOS cascade at rfft bin frequencies.

    Computed host-side in float64: H[k] = prod_s (b0 + b1 z + b2 z^2) /
    (1 + a1 z + a2 z^2) with z = exp(-2i pi k / nfft).
    """
    sos = np.asarray(sos, dtype=np.float64)
    k = np.arange(nfft // 2 + 1)
    z = np.exp(-2j * np.pi * k / nfft)
    h = np.ones_like(z)
    for sec in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = sos[sec]
        h *= (b0 + b1 * z + b2 * z * z) / (1.0 + a1 * z + a2 * z * z)
    return h


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sosfilt_fft(sos, x: jnp.ndarray, pad: int = 4096) -> jnp.ndarray:
    """SOS cascade applied in the frequency domain (the long-waveform path).

    One rfft / pointwise multiply / irfft instead of a 25-level
    associative-scan graph — XLA compiles it in seconds where the scan
    form takes tens of minutes at 10-minute-waveform sizes, and the
    runtime is bandwidth-optimal.  Zero-padding by `pad` (> the filter's
    impulse-response length) gives linear-convolution semantics at the
    head; steady state matches the exact IIR to fp tolerance, and the
    start-up transient differs only within the first ~IR-length samples
    (masked by the decoder's edge buffer, and strictly more faithful than
    the upstream per-chunk state resets).
    """
    n = x.shape[0]
    nfft = next_pow2(n + pad)
    h = sos_freq_response(sos, nfft)
    # transfer the response as float planes and combine on device
    hr = jnp.asarray(np.ascontiguousarray(h.real), dtype=x.dtype)
    hi = jnp.asarray(np.ascontiguousarray(h.imag), dtype=x.dtype)
    spec = jnp.fft.rfft(x, nfft) * jax.lax.complex(hr, hi)
    return jnp.fft.irfft(spec, nfft)[:n].astype(x.dtype)


def sosfilt_scan(sos, x: jnp.ndarray) -> jnp.ndarray:
    """Sequential SOS cascade with scipy's exact update order (validation)."""
    sos = jnp.asarray(sos, dtype=x.dtype)
    nsec = sos.shape[0]

    def step(state, xn):
        def section(carry, sec_state):
            val, k = carry
            b0, b1, b2 = sos[k, 0], sos[k, 1], sos[k, 2]
            a1, a2 = sos[k, 4], sos[k, 5]
            z1, z2 = sec_state[0], sec_state[1]
            y = b0 * val + z1
            z1n = b1 * val + z2 - a1 * y
            z2n = b2 * val - a2 * y
            return (y, k + 1), jnp.stack([z1n, z2n])

        (yn, _), new_state = lax.scan(section, (xn, 0), state)
        return new_state, yn

    init = jnp.zeros((nsec, 2), dtype=x.dtype)
    _, y = lax.scan(step, init, x)
    return y


def boxsmooth_lag(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Causal (lagging) box mean over the trailing ``window + 1`` samples.

    Device counterpart of the reference's incremental smoother
    (demodulate.py:39-48) applied in one whole-waveform pass: cumulative
    sum, shifted difference, divided by the per-position window length
    (shorter near the start).
    """
    csum = jnp.cumsum(x)
    n = x.shape[0]
    idx = jnp.arange(n)
    lo = jnp.maximum(idx - window, 0)
    total = csum - jnp.where(lo > 0, jnp.take(csum, lo - 1), 0)
    count = (idx - lo + 1).astype(x.dtype)
    return total / count
