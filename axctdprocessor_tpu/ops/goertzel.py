"""Windowed multi-tone DFT power probes (the pipeline's FLOP core).

The reference computes, per 0.1 s window at 25 windows/s, the magnitude
of the single-bin DFT at 400 Hz / 7500 Hz / a dead frequency
(AXCTDprocessor.py:355-364), and per demodulated bit the magnitudes at
the mark/space frequencies (demodulate.py:99-102) — all as Python loops
over ``np.sum``.

Here both become matrix products:

* :func:`framed_tone_power` — strided frames of the waveform against a
  (window x 2F) cos/sin matrix: one ``(n_win, window) @ (window, 2F)``
  product per waveform.
* :func:`tone_power_at` — per-bit powers at arbitrary start indices
  (the bit edges), same structure with a short window.

Power is reported as ``sqrt((x.c)^2 + (x.s)^2)`` — identical to the
reference's ``abs(sum(x cos + i x sin))``.

Every product names its precision: :data:`PRECISION`, unless a caller
measures another.  Left at ``DEFAULT``, a float32 product runs in TF32
on the GPU (about three decimal digits), and these sums feed two-decimal
log-ratio thresholds and mark/space power comparisons, so a borderline
frame could flip.  Full float32 costs about 1 ms more per 600 s of audio
on an H100 (the products timed alone), and ``DEFAULT`` misses
:data:`POWER_RTOL` by two orders of magnitude.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

PRECISION = lax.Precision.HIGHEST

# Error bound of the float32 tone powers and bit probes against a
# float64 evaluation of the same sums, relative to the largest power of
# each tone column.  Measured at the 600 s shape on an H100: 1.4e-6
# (powers, sums of ~4,410 terms) and 3.6e-7 (probes) at HIGHEST, against
# 3.9e-3 and 1.9e-4 at DEFAULT, where the products run in TF32.
# chip_smoke.py (phase 8) and tests/test_gpu_bringup.py hold the
# products to it.
POWER_RTOL = 1e-5


def tone_matrix(window: int, freqs, fs: float, dtype=np.float64) -> np.ndarray:
    """(window, 2F) matrix of interleaved cos/sin columns per frequency."""
    k = 2 * np.pi * np.arange(window) / fs
    cols = []
    for f in freqs:
        cols.append(np.cos(k * f))
        cols.append(np.sin(k * f))
    return np.stack(cols, axis=1).astype(dtype)


def framed_tone_power(x: jnp.ndarray, window: int, stride: int, trig,
                      precision=PRECISION) -> jnp.ndarray:
    """Tone power of every length-`window` frame at the given stride.

    Returns (n_win, F).  n_win follows the reference's window count for a
    buffer of this length: frames starting at 0, stride apart, with start
    < len(x) - window (strict, AXCTDprocessor.py:357).
    """
    trig = jnp.asarray(trig, dtype=x.dtype)
    n = x.shape[0]
    n_win = max(int(np.ceil((n - window) / stride)), 0)
    starts = jnp.arange(n_win) * stride
    frames = x[starts[:, None] + jnp.arange(window)[None, :]]
    proj = jnp.matmul(frames, trig, precision=precision)  # (n_win, 2F)
    re, im = proj[:, 0::2], proj[:, 1::2]
    return jnp.sqrt(re * re + im * im)


def framed_tone_power_tiled(x: jnp.ndarray, window: int, stride: int, trig,
                            precision=PRECISION) -> jnp.ndarray:
    """Strided-window tone power without materializing the frame matrix.

    Decomposition: cut the waveform into stride-length tiles T (the
    stride divides every window start), split the trig matrix into
    ceil(window/stride) stride-aligned segments (zero-padded at the end),
    and compute one GEMM per segment: ``P_j = T @ trig_j``.  A window
    starting at tile w is then ``sum_j P_j[w + j]`` — three small matmuls
    and shifted adds instead of an (n_win, window) gather (which costs
    ~window/stride x the waveform in device memory).

    Matches :func:`framed_tone_power` up to fp reordering; the final
    1-2 windows see zero padding instead of clamped samples (both are
    out-of-signal garbage, masked by callers).
    """
    trig = jnp.asarray(trig, dtype=x.dtype)
    n = x.shape[0]
    n_win = max(int(np.ceil((n - window) / stride)), 0)
    n_seg = int(np.ceil(window / stride))
    n_tiles = int(np.ceil(n / stride))
    x_pad = jnp.pad(x, (0, n_tiles * stride - n))
    tiles = x_pad.reshape(n_tiles, stride)

    proj = None
    for j in range(n_seg):
        seg = trig[j * stride : min((j + 1) * stride, window)]
        seg = jnp.pad(seg, ((0, stride - seg.shape[0]), (0, 0)))
        p_j = jnp.matmul(tiles, seg, precision=precision)  # (n_tiles, 2F)
        shifted = p_j[j : j + n_win] if j + n_win <= n_tiles else jnp.pad(
            p_j[j:], ((0, j + n_win - n_tiles), (0, 0)))
        proj = shifted if proj is None else proj + shifted
    re, im = proj[:, 0::2], proj[:, 1::2]
    return jnp.sqrt(re * re + im * im)


def tone_power_at(x: jnp.ndarray, starts: jnp.ndarray, window: int, trig,
                  precision=PRECISION) -> jnp.ndarray:
    """Tone power of frames beginning at arbitrary indices (e.g. bit edges).

    `starts` may contain clamped/invalid entries; caller masks.  Returns
    (len(starts), F).

    Lowered as a short correlation over the whole waveform followed by a
    narrow row gather of the (len(starts), 2F) results, instead of a
    (len(starts), window) frame gather.
    """
    trig = jnp.asarray(trig, dtype=x.dtype)
    starts = jnp.clip(starts, 0, x.shape[0] - window)
    # correlation: out[f, t] = sum_k x[t + k] * trig[k, f]
    proj_all = lax.conv_general_dilated(
        x[None, None, :], trig.T[:, None, :], (1,), "VALID",
        precision=precision)[0]  # (2F, n-w+1)
    proj = proj_all.T[starts]
    re, im = proj[:, 0::2], proj[:, 1::2]
    return jnp.sqrt(re * re + im * im)
