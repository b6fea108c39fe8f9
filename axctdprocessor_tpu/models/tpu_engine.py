"""Whole-waveform fused AXCTD decoder for an accelerator.

Where the parity engine replays the reference's per-chunk state machine
(required for byte-identical output), this engine decodes the entire
waveform in ONE fused device program — a single dispatch and a single
blocking device->host transfer per file:

* **stage 1 (front end)** — framed multi-tone DFT powers as matmuls,
  causal smoothing, whole-waveform Butterworth via FFT-domain filtering,
  zero-crossing extraction, pointer-doubling bit-edge chaining, and
  per-bit mark/space powers: everything expensive, with static shapes,
  no data-dependent control flow.
* **trigger logic (device)** — pulse detection, 7500 Hz baseline, tone/
  timeout profile trigger over the 25 Hz power series, with exact
  integer window comparisons precomputed on host (trigger_tables).
* **stage 1.5 (device)** — bit-decision scale calibration from the
  header-1 confidence histogram, bit calls, header-window compaction.
* **header codec (device)** — trim, '10'+CRC frame sync (pointer
  doubling), counter decode, coefficient decode (exact integer
  mantissa/exponent shipped back so the host reconstructs float64
  metadata bit-identically), and the live-coefficient merge with the
  upstream zcoeff-gate quirk (ops.header_device).
* **stage 2 (device)** — profile frame sync over every bit offset at
  once (CRC as GF(2) matmul + pointer-doubling jump chain), frame field
  extraction, LUT/polynomial/PSS-78 conversion, and both QC filters with
  masked percentiles.

Known, deliberate deviations from the reference chunk semantics (all
decode-quality-neutral or better; the parity engine remains the
byte-exact path):

* the tone-power window grid is uniform over the whole file — the
  reference's grid restarts at each (bit-aligned, data-dependent) chunk
  start and skips two windows per chunk boundary;
* the demodulation filter runs once over the whole waveform instead of
  restarting per chunk (no per-chunk transients);
* bit->time association uses true bit edges — the reference accumulates
  one duplicated buffer index per chunk, skewing its reported times;
* the recalibrated bit-decision scale applies from the end of the
  header-1 capture window rather than from the next chunk boundary.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import chain as chain_ops
from ..ops import crc as crc_ops
from ..ops import goertzel, iir
from ..utils.config import DecoderConfig, resolve_settings
from ..utils.lut import load_temp_lut
from . import frames as frames_host
from . import metadata as md
from .parity_engine import DecodeResult


# ---------------------------------------------------------------------------
# static sizing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineDims:
    """Static shape parameters (one compilation per distinct set)."""

    n: int              # waveform length
    n_power: int        # power window length (fs/10)
    d_pcm: int          # power window stride (fs/25)
    n_win: int
    npcm: int           # per-bit probe window
    max_crossings: int
    max_edges: int
    max_frames: int

    @classmethod
    def for_waveform(cls, n: int, fs: float, bitrate: float, npcm: int) -> "EngineDims":
        n_power = int(fs / 10)
        d_pcm = int(round(fs / 25))
        n_win = max(int(math.ceil((n - n_power) / d_pcm)), 1)
        max_edges = int(n * bitrate / fs * 1.25) + 64
        # crossing capacity is duration-based (Rice-rate ceiling for the
        # filtered band; see ops.chain.CROSSINGS_PER_SECOND) — capacity
        # directly scales the pointer-doubling chain's gather cost (a
        # sample-based n//8 bound was ~80% larger at 44.1 kHz for no
        # coverage gain)
        max_crossings = max(
            int(n / fs * chain_ops.CROSSINGS_PER_SECOND) + 1024, 4096)
        return cls(
            n=n, n_power=n_power, d_pcm=d_pcm, n_win=n_win, npcm=npcm,
            max_crossings=max_crossings,
            max_edges=max_edges,
            max_frames=max_edges // 32 + 8,
        )


# ---------------------------------------------------------------------------
# stage 1: powers + filter + bit edges + bit tone powers (device)
# ---------------------------------------------------------------------------

def sos_response_on_device(sos_arr, nfft: int):
    """Exact SOS cascade frequency response at rfft bins, device-computed.

    Building the response from the 18 biquad coefficients on device costs
    ~1 GFLOP of transcendentals — versus shipping a ~134 MB precomputed
    table from the host per call.  Bin indices stay <= 2^24, so float32
    holds them exactly.
    """
    k = jnp.arange(nfft // 2 + 1, dtype=jnp.float32)
    theta = k * jnp.float32(2.0 * np.pi / nfft)
    z = jax.lax.complex(jnp.cos(theta), -jnp.sin(theta))
    h = jax.lax.complex(jnp.ones_like(theta), jnp.zeros_like(theta))
    for sec in range(sos_arr.shape[0]):
        b0, b1, b2, _, a1, a2 = (sos_arr[sec, j] for j in range(6))
        num = b0 + z * (b1 + z * b2)
        den = 1.0 + z * (a1 + z * a2)
        h = h * num / den
    return h


def unpack_int4(packed, n: int):
    """Unpack ops.wire's 2-samples-per-byte int4 stream to int32 PCM.

    Interleaving is two interior-padded adds (lax.pad) — no (N, 2)
    intermediate with a 2-wide minor dimension."""
    u = packed.astype(jnp.int32)
    hi = (u >> 4) - 8
    lo = (u & 15) - 8
    x = jax.lax.pad(hi, jnp.int32(0), [(0, 1, 1)]) \
        + jax.lax.pad(lo, jnp.int32(0), [(1, 0, 1)])
    return x[:n]


def condition_integer(pcm, n: int, n_valid):
    """Device conditioning of raw integer PCM: DC removal + peak
    normalization (reference readAXCTDwavfile, AXCTDprocessor.py:55-57).

    Shipping int16 halves the host->device transfer.  ``n_valid`` (true
    length of a zero-padded buffer) keeps the mean exact: zeros
    contribute nothing to the sum or the peak, but averaging over the
    padded length would dilute the DC estimate and shift every zero
    crossing."""
    xf = pcm.astype(jnp.float32)
    denom = jnp.float32(n) if n_valid is None else n_valid.astype(jnp.float32)
    mean = jnp.sum(xf) / denom
    peak = jnp.maximum(jnp.max(jnp.abs(xf)), 1.0)
    x = (xf - mean) / peak
    if n_valid is not None:
        x = jnp.where(jnp.arange(n) < n_valid, x, 0.0)
    return x


def decimate2_on_device(x, n_valid, decim_sos):
    """Zero-phase decimation by 2 (the reference's scipy.signal.decimate
    for >50 kHz inputs, AXCTDprocessor.py:60-62): the order-8 Chebyshev-I
    anti-alias filter applied with |H|^2 in the FFT domain (the spectral
    equivalent of filtfilt's forward-backward pass) and a stride-2
    slice.  Input is conditioned float PCM at the raw rate; returns
    (half-rate PCM, half-rate n_valid)."""
    n = x.shape[0]
    nfft = iir.next_pow2(n + 4096)
    h = sos_response_on_device(decim_sos, nfft)
    zero_phase = (h * jnp.conj(h)).real
    spec = jnp.fft.rfft(x, nfft) * zero_phase
    filtered = jnp.fft.irfft(spec, nfft)[:n]
    x2 = filtered[::2]
    if n_valid is None:
        return x2, None
    n_valid2 = (n_valid + 1) // 2
    x2 = jnp.where(jnp.arange(x2.shape[0]) < n_valid2, x2, 0.0)
    return x2, n_valid2


def stage1_core(pcm, power_trig, sos_arr, bit_trig,
                dims: EngineDims, fs: float, bitrate: float, bit_inset: int,
                edge_pad: int, n_valid=None):
    if pcm.dtype == jnp.uint8:  # packed int4 wire
        pcm = unpack_int4(pcm, 2 * pcm.shape[0])
    if jnp.issubdtype(pcm.dtype, jnp.integer):
        x = condition_integer(pcm, dims.n, n_valid)
    else:
        x = pcm
    # A. tone powers on the uniform whole-file grid, smoothed, as ratios
    with jax.named_scope("tone_power"):
        powers = goertzel.framed_tone_power_tiled(
            x, dims.n_power, dims.d_pcm, power_trig)
        p400 = iir.boxsmooth_lag(powers[:, 0], 5)
        p7500 = iir.boxsmooth_lag(powers[:, 1], 5)
        pdead = iir.boxsmooth_lag(powers[:, 2], 5)
        r400 = jnp.log10(p400 / pdead)
        r7500 = jnp.log10(p7500 / pdead)

    # B. demodulation front end: filter -> crossings -> greedy edge chain.
    # Frequency-domain filtering with the SOS response computed on device
    # (so no complex array crosses the host boundary): the associative-
    # scan IIR is kept for short blocks, but at whole-waveform sizes its
    # log-depth graph is slow to compile; see ops.iir.sosfilt_fft.
    nfft = iir.next_pow2(dims.n + 4096)
    response = sos_response_on_device(sos_arr, nfft)
    spec = jnp.fft.rfft(x, nfft) * response
    filtered = jnp.fft.irfft(spec, nfft)[: dims.n].astype(x.dtype)
    sgn = jnp.where(filtered >= 0, 1, -1)
    is_cross = jnp.concatenate([sgn[:-1] != sgn[1:], jnp.zeros((1,), bool)])
    is_cross &= jnp.arange(dims.n) >= edge_pad
    if n_valid is not None:
        # no bit edges in the zero-padded tail (the filter's ring-down
        # there would otherwise demodulate into garbage frames)
        is_cross &= jnp.arange(dims.n) < n_valid - 1
    big = np.iinfo(np.int32).max // 2
    crossings, n_cross, rovf = chain_ops.compact_indices_rowcap(
        is_cross, dims.max_crossings, big,
        row_cap=chain_ops.rowcap_for_fs(fs))

    edge_idx, n_edges = chain_ops.enumerate_bit_edges(
        crossings, n_cross, fs, bitrate, dims.max_edges)
    edge_samples = crossings[jnp.clip(edge_idx, 0, dims.max_crossings - 1)]

    # C. per-bit mark/space powers over the inset window
    probes = goertzel.tone_power_at(
        filtered, edge_samples + bit_inset, dims.npcm, bit_trig)
    # truncation indicator: crossings past the Rice-rate capacity were
    # dropped (graceful, but a clipped decode must be distinguishable)
    overflow = (n_cross > dims.max_crossings).astype(jnp.int32) | rovf
    return dict(r400=r400, r7500=r7500, edge_samples=edge_samples,
                n_edges=n_edges, s1=probes[:, 0], s2=probes[:, 1],
                overflow=overflow)


# ---------------------------------------------------------------------------
# stage 1.5: bit decisions + scale calibration + header windows (device)
# ---------------------------------------------------------------------------

HEADER_WINDOW_BITS = 6144  # capacity for one header capture window's bits


def stage15_core(c0, edge_samples, n_edges, h_bounds, calib_cut,
                 dims: EngineDims):
    """Demod decisions on device: calibrate the space-power scale from the
    header-1 confidence histogram (reference demodulate.py:124-157), call
    every bit, and compact the header-2/3 capture windows into small
    fixed-size buffers so the host only reads back ~12 KB.

    ``c0`` is the per-bit unscaled confidence ratio
    ``space_power / max(mark_power, 1e-30)`` — ONE stream instead of the
    two raw probe powers, because both consumers reduce to it: the
    calibration histogram bins ``conf = c0 * scale`` and the bit decision
    ``mark >= space * eff`` is exactly ``c0 * eff <= 1`` (the reference's
    ``p1 >= p2`` with the scale already folded into p2,
    demodulate.py:80-82).  Shipping the ratio halves the probe-table
    merge traffic and drops one 660k random gather from the assemble
    program.

    `h_bounds` is int32[6]: (h1_lo, h1_hi, h2_lo, h2_hi, h3_lo, h3_hi)
    inclusive PCM-sample bounds of the three capture windows.
    """
    me = dims.max_edges
    idx = jnp.arange(me)
    bit_valid = idx < n_edges - 1  # the final edge's bit is never emitted
    scale0 = jnp.float32(1.5)
    conf0 = c0 * scale0

    # edge_samples is non-decreasing (ascending while valid, then the
    # repeated terminal value), so every capture window is a CONTIGUOUS
    # run of edges: two binary searches + a fixed-size dynamic slice
    # replace full-length (max_edges) mask compactions and histogram
    # scatters over the whole edge domain.
    def window_span(lo, hi):
        lo_i = jnp.searchsorted(edge_samples, lo, side="left")
        hi_i = jnp.searchsorted(edge_samples, hi, side="right")
        lo_i = jnp.minimum(lo_i, jnp.maximum(n_edges - 1, 0))
        hi_i = jnp.minimum(hi_i, jnp.maximum(n_edges - 1, 0))
        n_sel = jnp.maximum(hi_i - lo_i, 0)  # empty/inverted window -> 0
        return lo_i.astype(jnp.int32), n_sel.astype(jnp.int32)

    h1_lo, n_h1 = window_span(h_bounds[0], h_bounds[1])
    wloc = jnp.arange(HEADER_WINDOW_BITS)
    # zero-pad the sliced arrays so dynamic_slice never clamps the start
    # (a window beginning in the last HEADER_WINDOW_BITS edges would
    # otherwise be silently shifted); the mask handles the tail
    conf0_ext = jnp.concatenate(
        [conf0, jnp.zeros((HEADER_WINDOW_BITS,), conf0.dtype)])

    # histogram of confidences on [0, 3) in 0.01 bins (299 bins),
    # over the h1 window only (its span is ~1600 bits)
    vals = jnp.where(wloc < n_h1,
                     jax.lax.dynamic_slice(conf0_ext, (h1_lo,),
                                       (HEADER_WINDOW_BITS,)), -1.0)
    bin_idx = jnp.floor(vals * 100.0).astype(jnp.int32)
    in_range = (bin_idx >= 0) & (bin_idx < 299)
    counts = jnp.zeros((300,), jnp.int32).at[
        jnp.where(in_range, bin_idx, 299)].add(1)[:299]
    cum = 100.0 * jnp.cumsum(counts).astype(jnp.float32) / jnp.maximum(n_h1, 1)
    centers = (jnp.arange(299, dtype=jnp.float32) + 0.5) * 0.01
    slope_mid = (cum[2:] - cum[:-2]) / 0.02
    slope = jnp.concatenate([
        (cum[1:2] - cum[0:1]) / 0.01, slope_mid, (cum[-1:] - cum[-2:-1]) / 0.01])
    in_band = (cum >= 30.0) & (cum <= 65.0)
    inf = jnp.float32(np.inf)
    min_slope = jnp.min(jnp.where(in_band, slope, inf))
    is_min = in_band & (slope == min_slope)
    first_c = centers[jnp.argmax(is_min)]
    last_c = centers[298 - jnp.argmax(is_min[::-1])]
    threshold = 0.5 * (first_c + last_c)
    ok = (n_h1 > 50) & jnp.any(in_band) & (threshold > 0)
    scale_new = jnp.where(ok, scale0 / threshold, scale0)

    eff = jnp.where(edge_samples <= calib_cut, scale0, scale_new)
    bits = ((c0 * eff <= 1.0) & bit_valid).astype(jnp.int32)

    bits_ext = jnp.concatenate(
        [bits, jnp.zeros((HEADER_WINDOW_BITS,), bits.dtype)])

    def window(lo, hi):
        lo_i, n_sel = window_span(lo, hi)
        w = jax.lax.dynamic_slice(bits_ext, (lo_i,), (HEADER_WINDOW_BITS,))
        return jnp.where(wloc < n_sel, w, 0), n_sel

    h2_bits, h2_n = window(h_bounds[2], h_bounds[3])
    h3_bits, h3_n = window(h_bounds[4], h_bounds[5])
    return dict(bits=bits, scale=scale_new, h2_bits=h2_bits, h2_n=h2_n,
                h3_bits=h3_bits, h3_n=h3_n)


# ---------------------------------------------------------------------------
# stage 2: profile frame sync + conversion + QC (device)
# ---------------------------------------------------------------------------

def stage2_core(bits, n_bits, edge_samples, r400_win, r7500_win, mean7500,
                profstart, dims: EngineDims, fs: float):
    """Profile frame sync on device; science conversion + QC run on the
    HOST (attach_profile) from the lean per-frame outputs.

    The device ships only what it alone can produce — frame words, frame
    start samples, per-frame tone ratios — because (a) the packed result
    is the decode's one D2H transfer and this halves it (486 -> 245 KB
    at 600 s scale), and (b) the reference converts and QCs in float64
    on the host (parse.py:103-147, AXCTDprocessor.py:559-609) — doing
    the same in numpy from the exact frame integers is parity-faithful by
    construction, where the old on-device float32 conversion could flip
    a rounded 2-decimal digit.  20k rows of host numpy is microseconds."""
    me = dims.max_edges
    idx = jnp.arange(me)

    # 1. drop bits at/before the profile start; compact to the front
    in_prof = (idx < n_bits) & (edge_samples > profstart)
    first = jnp.argmax(in_prof)
    n_prof = jnp.sum(in_prof.astype(jnp.int32))
    bits_p = jnp.roll(bits, -first)
    edges_p = jnp.roll(edge_samples, -first)

    # per-bit signal ratios: nearest power window on the uniform grid
    win = jnp.clip(jnp.round(edges_p / dims.d_pcm).astype(jnp.int32),
                   0, dims.n_win - 1)
    bit_r400 = r400_win[win]
    bit_r7500 = r7500_win[win] - mean7500

    # 2. the 32-bit frame word at EVERY bit offset (32 shifted adds over
    # the bit stream: one fused elementwise pass, sequential memory
    # traffic).  This replaces a (max_frames, 32) random gather — 660k
    # gathered elements at 600 s scale — with streaming adds, and CRC
    # validity derives from the SAME words (6 popcounts,
    # ops.crc.check_crc_words) instead of a second 32-pass shifted-XOR
    # sweep over the bit stream.
    bext32 = jnp.concatenate(
        [bits_p.astype(jnp.uint32), jnp.zeros((32,), jnp.uint32)])
    word = jnp.zeros((me,), jnp.uint32)
    for k in range(32):  # Horner: word[i] = sum_k bits_p[i+k] << (31-k)
        word = (word << 1) | bext32[k : k + me]

    # 3. frame acceptance per offset: '10' + CRC + positive 7500 ratio
    # (zero words past the stream read CRC-valid; the n_prof - 32 tail
    # mask excludes them, matching check_crc_all_windows' own guard)
    crc_valid = crc_ops.check_crc_words(word)
    nxt = jnp.roll(bits_p, -1)
    accept = (bits_p == 1) & (nxt == 0) & crc_valid & (bit_r7500 > 0)
    accept &= idx < n_prof - 32

    starts, n_frames, consumed, sync_ovf = chain_ops.enumerate_frames(
        accept, n_prof, max_steps=me, max_frames=dims.max_frames)

    # frame hex ships as one packed uint32 per frame (host formats %08x)
    hexpack = word[starts]

    # 4. lean per-frame outputs: absolute frame-start samples (exact
    # ints; the host recovers times_raw = (edge - profstart)/fs in
    # float64) and the 2-decimal tone ratios the QC gates on
    edge_at = edges_p[starts].astype(jnp.int32)
    fr400 = jnp.round(bit_r400[starts], 2)
    fr7500 = jnp.round(bit_r7500[starts], 2)

    return dict(edges=edge_at, r400=fr400, r7500=fr7500, hexpack=hexpack,
                n_frames=n_frames, consumed=consumed,
                overflow=sync_ovf << 2)  # bits 2-3: accept/frame tables


# ---------------------------------------------------------------------------
# device trigger logic + fused back half (trigger -> bits -> headers ->
# profile, one device program; reference AXCTDprocessor.py:374-408,433-535)
# ---------------------------------------------------------------------------

def trigger_tables(cfg: DecoderConfig, fs: float):
    """Precomputed trigger parameters for the device trigger.

    Window positions are integers, so every host float comparison
    ``win >= fp + c*fs`` converts exactly to an integer threshold
    (computed here in float64) — the device never does float index math
    that would lose precision past 2^24 samples.
    """
    tr0, tr1 = cfg.trigger_range
    trig_i = np.asarray([
        int(math.ceil(4.5 * fs)),            # baseline lo:  rel >= .
        int(math.floor(5.5 * fs)),           # baseline hi:  rel <= .
        int(math.floor(tr0 * fs)) + 1,       # trigger:      rel >= . (== rel > tr0*fs)
        # both the reach test and the offset truncate (reference
        # AXCTDprocessor.py:404-405 uses int(fs*tr1) for both): a ceil'd
        # reach would fire one window later when tr1*fs is non-integer
        int(tr1 * fs) if tr1 > 0 else 0,     # timeout reach
        int(tr1 * fs) if tr1 > 0 else 0,     # timeout profstart offset
        1 if tr1 > 0 else 0,                 # timeout enabled
        1 if cfg.compat == "fixed" else 0,   # elif-quirk bypass (PARITY #16)
    ], np.int32)
    trig_f = np.asarray([cfg.min_r400, cfg.min_dr7500], np.float32)
    return trig_i, trig_f


def header_rel_offsets(fs: float) -> np.ndarray:
    """PCM offsets of the three header capture windows relative to the
    pulse start (reference windows +-0.5 s, AXCTDprocessor.py:447-456)."""
    rel = (2.3 - 0.5, 3.3 + 0.5, 10.5 - 0.5, 14.8 + 0.5, 20.0 - 0.5, 24.5 + 0.5)
    return np.asarray([int(fs * r) for r in rel], dtype=np.int32)


def trigger_core(r400, r7500, n_valid, trig_i, trig_f, dims: EngineDims,
                 fs: float):
    """Device port of :func:`trigger_scalars`: pulse detection, 7500 Hz
    baseline, profile trigger (tone rise or hard timeout) over the real
    (non-padded) power-window grid.  Returns (firstpulse|-1, mean7500,
    profstart|-1) as device scalars.

    The window count comes from ``r400`` itself (the time-sharded front
    end's uniform grid has a couple more trailing windows than the
    single-device ceil((n - n_power)/d_pcm) grid)."""
    n_win = r400.shape[0]
    idx = jnp.arange(n_win, dtype=jnp.int32)
    win = idx * dims.d_pcm
    n_power = int(fs / 10)
    n_win_true = jnp.maximum((n_valid - n_power + dims.d_pcm - 1) // dims.d_pcm, 1)
    n_win_true = jnp.minimum(n_win_true, n_win)
    real = idx < n_win_true

    hit = real & (r400 >= trig_f[0])
    any_hit = jnp.any(hit)
    fp = jnp.where(any_hit, win[jnp.argmax(hit)], -1).astype(jnp.int32)

    rel = win - fp
    base = real & (rel >= trig_i[0]) & (rel <= trig_i[1]) & ~jnp.isnan(r7500)
    cnt = jnp.sum(base.astype(jnp.int32))
    mean7500 = jnp.where(
        cnt > 0, jnp.sum(jnp.where(base, r7500, 0.0)) / cnt, jnp.nan)
    tone_path = ~jnp.isnan(mean7500)

    trig = real & (rel >= trig_i[2]) & (r7500 - mean7500 >= trig_f[1])
    any_trig = tone_path & jnp.any(trig)
    last_rel = win[n_win_true - 1] - fp
    timeout = (trig_i[5] > 0) & ((trig_i[6] > 0) | ~tone_path) & \
        (last_rel >= trig_i[3])
    profstart = jnp.where(any_trig, win[jnp.argmax(trig)],
                          jnp.where(timeout, fp + trig_i[4], -1))
    profstart = jnp.where(any_hit, profstart, -1).astype(jnp.int32)
    mean7500 = jnp.where(any_hit, mean7500, jnp.nan)
    return fp, mean7500, profstart


def back_half_core(r400, r7500, edge_samples, n_edges, c0p, n_valid,
                   trig_i, trig_f, hdr_rel, calib_off, coeff_defaults,
                   temp_lut, limits, dims: EngineDims, fs: float,
                   overflow0=None):
    """Everything after the DSP front end, fused on device: trigger
    scalars, bit decisions + calibration, header trim/sync/decode, live
    coefficient merge, and the profile stage.  Only the final result
    tree crosses to the host (one blocking transfer).

    ``c0p`` is the per-edge confidence ratio
    ``space/max(mark, 1e-30)`` (see stage15_core — one stream carries
    both the bit decisions and the calibration histogram).

    ``overflow0`` carries the caller's stage-1 truncation bit (crossing
    capacity); the edge-table and frame-sync bits are added here and the
    combined indicator ships in ``scal_i[5]`` (DecodeResult.overflow)."""
    from ..ops import header_device as hdr

    fp, mean7500, profstart = trigger_core(r400, r7500, n_valid, trig_i,
                                           trig_f, dims, fs)
    # empty header windows when no pulse was found
    big = jnp.int32(2 ** 30)
    lo_mask = jnp.asarray([True, False, True, False, True, False])
    hb = jnp.where(fp >= 0, fp + hdr_rel, jnp.where(lo_mask, big, -big))
    s15 = stage15_core(c0p, edge_samples, n_edges, hb, fp + calib_off,
                       dims)

    h2_found, h2_frames, h2_usable = hdr.parse_header_window(
        s15["h2_bits"], s15["h2_n"])
    h3_found, h3_frames, h3_usable = hdr.parse_header_window(
        s15["h3_bits"], s15["h3_n"])
    v2, ok2, _, _, crash2 = hdr.decode_coefficients(h2_found, h2_frames)
    v3, ok3, _, _, crash3 = hdr.decode_coefficients(h3_found, h3_frames)
    ok2 &= ~crash2  # upstream int() ValueError discards the whole header
    ok3 &= ~crash3
    del v2, ok2, v3, ok3  # decoded on host from the shipped raw headers;
    # the device merge (ops.header_device.merge_live_coeffs) remains
    # available for fully device-resident pipelines

    out = stage2_core(s15["bits"], n_edges - 1, edge_samples, r400, r7500,
                      mean7500, profstart, dims, fs)
    gate = profstart >= 0

    ovf = (jnp.asarray(0, jnp.int32) if overflow0 is None
           else overflow0.astype(jnp.int32))
    ovf |= (n_edges >= dims.max_edges).astype(jnp.int32) << 1
    ovf |= out["overflow"]

    # the whole result tree packs into ONE int32 vector, fetched in one
    # device->host transfer.  Per frame only 3 words ship — the u32
    # frame word, the exact frame-start sample, and the two QC tone
    # ratios as int16 centi-units (2-decimal by contract; NaN -> -32768
    # sentinel) — science conversion and QC happen on the host in
    # float64 (attach_profile), exactly like the reference.
    hdr = jnp.concatenate([
        h2_found.astype(jnp.int32), h3_found.astype(jnp.int32),
        h2_frames.reshape(-1), h3_frames.reshape(-1)])
    scal_i = jnp.stack([fp, profstart, jnp.where(gate, out["n_frames"], 0),
                        h2_usable.astype(jnp.int32),
                        h3_usable.astype(jnp.int32), ovf])
    scal_f = jnp.stack([mean7500, s15["scale"]]).astype(jnp.float32)

    def fix16(x):
        v = jnp.clip(jnp.round(x * 100.0), -32000, 32000)
        return jnp.where(jnp.isnan(x), -32768, v.astype(jnp.int32)) \
            .astype(jnp.int16)

    rat16 = jnp.stack([fix16(out["r400"]), fix16(out["r7500"])])
    rat_i32 = jax.lax.bitcast_convert_type(
        rat16.reshape(-1, 2), jnp.int32)
    # explicit int32 on every part: under x64 a weakly-typed int in any
    # component would promote the whole concatenate to int64 and the
    # host's fixed-width views would misparse the buffer
    parts = [scal_i,
             jax.lax.bitcast_convert_type(scal_f, jnp.int32),
             hdr,
             jax.lax.bitcast_convert_type(out["hexpack"], jnp.int32),
             out["edges"], rat_i32]
    return jnp.concatenate([p.astype(jnp.int32) for p in parts])


def fused_core(pcm, n_valid, power_trig, sos_arr, bit_trig, trig_i, trig_f,
               hdr_rel, calib_off, coeff_defaults, temp_lut, limits,
               dims: EngineDims, fs: float, bitrate: float, bit_inset: int,
               edge_pad: int, decimate2: bool = False, decim_sos=None):
    """Whole decode as one device program: stage 1 front end + back half.

    With ``decimate2`` the raw input is at 2x the decode rate (>50 kHz
    WAVs): conditioning + zero-phase anti-alias decimation run on device
    first, so high-rate files keep the half-size integer transfer
    (reference AXCTDprocessor.py:60-62 does this on host with scipy).
    ``dims``/``fs`` always describe the post-decimation stream."""
    if pcm.dtype == jnp.uint8:  # packed int4 wire
        pcm = unpack_int4(pcm, 2 * pcm.shape[0])
    if decimate2:
        if jnp.issubdtype(pcm.dtype, jnp.integer):
            x = condition_integer(pcm, pcm.shape[0], n_valid)
        else:
            x = pcm
        x, n_valid = decimate2_on_device(x, n_valid, decim_sos)
    else:
        x = pcm
    with jax.named_scope("stage1"):
        s1 = stage1_core(x, power_trig, sos_arr, bit_trig, dims, fs,
                         bitrate, bit_inset, edge_pad, n_valid=n_valid)
    c0 = s1["s2"] / jnp.maximum(s1["s1"], 1e-30)
    return back_half_core(s1["r400"], s1["r7500"], s1["edge_samples"],
                          s1["n_edges"], c0, n_valid,
                          trig_i, trig_f, hdr_rel, calib_off, coeff_defaults,
                          temp_lut, limits, dims, fs,
                          overflow0=s1["overflow"])


_fused = functools.partial(
    jax.jit,
    static_argnames=("dims", "fs", "bitrate", "bit_inset", "edge_pad",
                     "decimate2"),
)(fused_core)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _engine_tables_cached(key, fs: float, n_power: int, npcm: int):
    mark, space, dead, use_bp = key
    power_trig = goertzel.tone_matrix(n_power, [400.0, 7500.0, dead], fs,
                                      dtype=np.float32)
    bit_trig = goertzel.tone_matrix(npcm, [mark, space], fs, dtype=np.float32)
    sos = iir.design_sos(fs, use_bp)
    return power_trig, bit_trig, sos


def engine_tables(cfg: DecoderConfig, fs: float, dims: EngineDims, dtype=np.float32):
    """Host-designed constant tables (cached): tone matrices + SOS.

    The demodulation filter crosses to the device as its 18 raw SOS
    coefficients; stage 1 evaluates the exact rfft-bin response on device
    (sos_response_on_device)."""
    key = (cfg.mark_freq, cfg.space_freq, cfg.dead_freq, cfg.use_bandpass)
    power_trig, bit_trig, sos = _engine_tables_cached(key, fs, dims.n_power,
                                                      dims.npcm)
    return power_trig, bit_trig, sos.astype(dtype)


def qc_limits(cfg: DecoderConfig, dtype=np.float32) -> np.ndarray:
    return np.asarray([cfg.min_dr7500_inprof, cfg.min_r400_inprof,
                       cfg.tlims[0], cfg.tlims[1], cfg.slims[0], cfg.slims[1]],
                      dtype=dtype)


def attach_profile(result: DecodeResult, out: dict, cfg: DecoderConfig,
                   fs: float, profstart: int, live: dict) -> DecodeResult:
    """Science conversion + QC on the host, float64, from the lean
    per-frame device outputs (frame words, start samples, tone ratios).

    Mirrors the reference's host profile stage exactly — ascending
    polynomial evaluation, LUT gather, PSS-78, round to 2 decimals, THEN
    the bounds filter and the spike filter over the survivors
    (parse.py:103-147, AXCTDprocessor.py:559-609; same code path as
    models.parity_engine via models.convert)."""
    from . import convert

    n_frames = int(out["scal_i"][2])
    hexpack = np.asarray(out["hexpack"][:n_frames])
    edges = np.asarray(out["edges"][:n_frames], dtype=np.int64)
    fr = np.asarray(out["ratios"][:, :n_frames], dtype=np.float64)
    fr[fr == -32768] = np.nan  # int16 NaN sentinel
    r400, r7500 = fr / 100.0

    tint = (hexpack >> 6) & 0xFFF    # frame bits 14:26
    cint = (hexpack >> 18) & 0xFFF   # frame bits 2:14
    times_raw = (edges - profstart) / fs
    temps, conds, psals, depths = convert.ints_to_observations(
        tint, cint, times_raw, load_temp_lut(),
        live["tcoeff"], live["ccoeff"], live["zcoeff"])

    times = np.round(times_raw + profstart / fs, 2)
    depths = np.round(depths, 2)
    temps = np.round(temps, 2)
    conds = np.round(conds, 2)
    psals = np.round(psals, 2)

    good = convert.qc_bounds_mask(r400, r7500, temps, psals, cfg)
    if np.any(good):
        sub = np.flatnonzero(good)
        good[sub] &= convert.qc_spike_mask(temps[sub], psals[sub])

    result.time = list(times[good])
    result.depth = list(depths[good])
    result.temperature = list(temps[good])
    result.conductivity = list(conds[good])
    result.salinity = list(psals[good])
    result.r400 = list(r400[good])
    result.r7500 = list(r7500[good])
    # hexframes bypass QC (upstream contract); hexframes_qc is aligned
    result.hexframes = [f"{w:08x}" for w in hexpack]
    result.hexframes_qc = [f"{w:08x}" for w in hexpack[good]]
    return result


HDR_N = 72  # found flags per header in the packed hdr array
_HDR_LEN = 10 * HDR_N
_HEAD_LEN = 6 + 2 + _HDR_LEN  # scal_i + scal_f + hdr prefix


def unpack_result(buf: np.ndarray) -> dict:
    """Inverse of back_half_core's single-vector packing: reconstruct
    the {hexpack, edges, ratios, hdr, scal_i, scal_f} tree on the host
    (all numpy views — microseconds).  ``ratios`` stays in raw int16
    centi-units (with the -32768 NaN sentinel); attach_profile decodes
    only the valid prefix."""
    buf = np.ascontiguousarray(np.asarray(buf), dtype=np.int32)
    mf = (buf.shape[0] - _HEAD_LEN) // 3
    scal_i = buf[:6]
    scal_f = buf[6:8].view(np.float32)
    hdr = buf[8 : 8 + _HDR_LEN]
    off = _HEAD_LEN
    hexpack = buf[off : off + mf].view(np.uint32)
    edges = buf[off + mf : off + 2 * mf]
    ratios = buf[off + 2 * mf :].view(np.int16).reshape(2, mf)
    return dict(hexpack=hexpack, edges=edges, ratios=ratios, hdr=hdr,
                scal_i=scal_i, scal_f=scal_f)


def finish_result(out, fs_report, n: int, fs: float,
                  cfg: DecoderConfig, wire_used: str | None = None) -> DecodeResult:
    """Build a DecodeResult from one fused-decode output (the packed
    int32 vector, or its unpacked tree; host side: status, exact float64
    metadata from the header frame arrays, report formatting — all
    microsecond-scale numpy/python)."""
    if not isinstance(out, dict):
        out = unpack_result(out)
    result = DecodeResult(fs=fs_report, numpoints=n, wire=wire_used)
    scal_i = np.asarray(out["scal_i"])
    if scal_i.shape[0] > 5:
        result.overflow = int(scal_i[5])
    fp = int(scal_i[0])
    if fp < 0:
        result.status = 0
        return result
    result.status = 1
    result.firstpulse400 = fp

    hdr = np.asarray(out["hdr"])
    h2 = (frames_host.header_dict_from_device(
              hdr[:HDR_N] > 0, hdr[2 * HDR_N: 6 * HDR_N].reshape(HDR_N, 4))
          if scal_i[3] else None)
    h3 = (frames_host.header_dict_from_device(
              hdr[HDR_N: 2 * HDR_N] > 0, hdr[6 * HDR_N:].reshape(HDR_N, 4))
          if scal_i[4] else None)
    live = {"tcoeff": list(cfg.tcoeff_default), "ccoeff": list(cfg.ccoeff_default),
            "zcoeff": list(cfg.zcoeff_default)}
    md.merge_headers(result.metadata, h2, h3, live)

    profstart = int(scal_i[1])
    if profstart < 0:
        return result
    result.status = 2
    result.profstartind = profstart
    result.firstpointtime = profstart / fs
    return attach_profile(result, out, cfg, fs, profstart, live)


def lossy_retry_worthy(res: DecodeResult, n: int, fs: float,
                       cfg: DecoderConfig) -> bool:
    """True when a lossy-wire (int4) decode looks DEGENERATE and is worth
    one lossless retry.

    The noise-shaped int4 wire has a content-dependent cliff: on inputs
    whose own noise floor sits near the bit-decision threshold, a
    particular error realization can flip the demod calibration and
    collapse the whole decode (measured: 20/64 of the bench's noisy 60 s
    drops decode ~30 frames instead of ~500, deterministically per row
    — scripts/diagnose_int4_row.py; the same
    rows decode perfectly at int8 or even PLAIN-rounded int4, and the
    encoder's error spectrum is healthy, scripts/diagnose_int4_psd.py).
    A collapse is unmistakable: a healthy AXCTD stream yields
    bitrate/32 = 25 frames/s of profile, a flipped calibration passes
    ~1-5% of CRCs by chance.  Retrying those at int8 keeps "auto" both
    fast (int4 upload for the overwhelming majority) and safe (lossless
    for the cliff cases) — the decode analog of a checksum-verified
    fast path."""
    if (res.wire or "") != "int4":
        return False
    if res.status != 2:
        return True  # no trigger/profile through the lossy wire: verify
    dur = max(n / fs - max(res.firstpointtime, 0.0), 1.0)
    expected = dur * cfg.bitrate / 32.0
    return len(res.hexframes) < 0.25 * expected


def trigger_scalars(r400: np.ndarray, r7500: np.ndarray, cfg: DecoderConfig,
                    fs: float, d_pcm: int, n_valid: int | None = None):
    """Host scalar logic over the 25 Hz power series: pulse detection,
    7500 Hz baseline, profile trigger.  Returns
    (firstpulse|-1, mean7500, profstart|-1).

    ``n_valid`` is the true (pre-padding) sample count: decode inputs are
    zero-padded to length buckets, and the hard-timeout trigger compares
    against the *last* power window — padding must not extend the grid or
    a short file could time out into status 2 where the reference
    (which only ever sees real windows) stays at status 1."""
    if n_valid is not None:
        n_power = int(fs / 10)
        n_win_true = max(int(math.ceil((n_valid - n_power) / d_pcm)), 1)
        r400 = r400[:n_win_true]
        r7500 = r7500[:n_win_true]
    win_samples = np.arange(len(r400)) * d_pcm
    pulse_hits = np.flatnonzero(r400 >= cfg.min_r400)
    if pulse_hits.size == 0:
        return -1, np.nan, -1
    firstpulse = int(win_samples[int(pulse_hits[0])])

    base_mask = (win_samples >= firstpulse + 4.5 * fs) & (
        win_samples <= firstpulse + 5.5 * fs)
    with np.errstate(invalid="ignore"):
        mean7500 = float(np.nanmean(r7500[base_mask])) if base_mask.any() else np.nan

    trig_mask = (win_samples > firstpulse + cfg.trigger_range[0] * fs) & (
        r7500 - mean7500 >= cfg.min_dr7500)
    profstart = -1
    tone_path = not np.isnan(mean7500)
    if tone_path and trig_mask.any():
        profstart = int(win_samples[np.flatnonzero(trig_mask)[0]])
    elif (cfg.trigger_range[1] > 0
          and (cfg.compat == "fixed" or not tone_path)
          and win_samples[-1] >= firstpulse + int(fs * cfg.trigger_range[1])):
        profstart = firstpulse + int(fs * cfg.trigger_range[1])
    return firstpulse, mean7500, profstart


BUCKET_SECONDS = 15  # decode-length granularity: one compilation per bucket
AUTO_SEGMENT_SECONDS = 300  # auto-route longer files through segmented decode


def fused_inputs(cfg: DecoderConfig, fs: float, dtype=np.float32):
    """The replicated parameter arrays of the fused decode program."""
    trig_i, trig_f = trigger_tables(cfg, fs)
    return dict(
        trig_i=jnp.asarray(trig_i), trig_f=jnp.asarray(trig_f),
        hdr_rel=jnp.asarray(header_rel_offsets(fs)),
        calib_off=jnp.asarray(int(fs * 3.8), jnp.int32),
        coeff_defaults=jnp.asarray(
            [cfg.zcoeff_default, cfg.tcoeff_default, cfg.ccoeff_default],
            jnp.float32),
        temp_lut=jnp.asarray(load_temp_lut(), dtype),
        limits=jnp.asarray(qc_limits(cfg), dtype),
    )


def decode_waveform_tpu(pcm, fs, config: DecoderConfig | None = None,
                        dtype=jnp.float32, pad_to_bucket: bool = True,
                        mode: str = "auto", wire: str = "auto",
                        lossy_retry: bool = True) -> DecodeResult:
    """Decode a conditioned (or raw-integer) waveform with the fused engine.

    The whole decode — DSP front end, trigger logic, bit calibration,
    header trim/sync/decode, profile frame sync, science conversion, QC —
    is ONE device program (`fused_core`): a single dispatch and a single
    blocking device->host transfer of the final result tree (profile
    rows + header frame arrays, ~0.7 MB for a 10-minute drop).  The host
    only reconstructs exact float64 metadata and formats the report.

    Waveforms are zero-padded up to 15 s length buckets so arbitrary file
    lengths share compilations; the true
    length is carried as ``n_valid`` so device conditioning stays exact,
    and padding is decode-neutral (no crossings, NaN power ratios,
    trigger grid clipped to real windows).

    ``mode``: "auto" routes files over AUTO_SEGMENT_SECONDS through the
    segmented engine (models.segmented — streamed per-segment upload
    overlapping compute, length-independent compilation),
    "monolithic"/"segmented" force a path.
    High-rate (>50 kHz) input decimates by 2 on device on either path.

    ``wire``: host->device format for integer PCM — "int16" ships samples
    verbatim; "int8" quantizes on host to halve the upload (~48 dB SNR,
    decode-equivalent; ops.wire); "int4" packs noise-shaped 4-bit
    samples (lossy); "auto" is int16.

    ``lossy_retry``: an int4-wire decode that comes back DEGENERATE
    (collapsed frame yield — see :func:`lossy_retry_worthy`) is retried
    once at the lossless-class int8 wire.  Pass False to measure the
    pure int4 path.
    """
    cfg = config or DecoderConfig()
    pcm = np.asarray(pcm)
    pcm0, fs0 = pcm, fs  # pre-encode originals (the lossless retry's input)
    if pcm.dtype == np.uint8:
        raise ValueError("pass unpacked integer PCM with wire='int4'; "
                         "pre-packed nibble streams lose the sample count")
    if mode != "monolithic":
        n0 = len(pcm)
        if mode == "segmented" or n0 > AUTO_SEGMENT_SECONDS * float(fs):
            from .segmented import decode_waveform_segmented

            return decode_waveform_segmented(pcm, fs, config=cfg, wire=wire,
                                             lossy_retry=lossy_retry)
    n_raw = int(len(pcm))  # true sample count (before any wire packing)
    if np.issubdtype(pcm.dtype, np.integer):
        from ..ops import wire as wire_ops

        wire_used = wire_ops.resolve_wire(wire, pcm.dtype)
        pcm = wire_ops.encode(pcm, wire_used)
    else:
        wire_used = "float32"  # conditioned float PCM ships verbatim
    packed4 = pcm.dtype == np.uint8  # int4 wire: 2 samples/byte
    # >50 kHz input decimates by 2 on device; the report then prints the
    # halved rate as a float, exactly like the reference's host `fs /= 2`
    decimate2 = float(fs) > 50000.0
    if decimate2:
        fs = float(fs) / 2.0
        fs_report = fs
    else:
        # the report prints fs verbatim: int for native rates, float
        # after decimation (so e.g. 48 kHz from a 96 kHz WAV is "48000.0")
        fs_report = float(fs) if isinstance(fs, float) else int(fs)
        fs = float(fs)
    rate_mult = 2 if decimate2 else 1
    if pad_to_bucket:
        unit = int(BUCKET_SECONDS * fs) * rate_mult
        n_padded = max(int(np.ceil(n_raw / unit)) * unit, unit)
    else:
        n_padded = n_raw
    if packed4:
        # the packed layout needs an even sample count (a 15 s bucket
        # can be odd at e.g. fs = 11025)
        n_padded += n_padded % 2
    if packed4:
        # pad with 0x88 (two zero-level nibbles), NOT zero bytes, so the
        # device-side DC mean over the padded tail stays exact
        need = n_padded // 2
        if len(pcm) < need:
            pcm = np.concatenate(
                [pcm, np.full(need - len(pcm), 0x88, np.uint8)])
    elif n_padded != n_raw:
        pcm = np.concatenate([pcm, np.zeros(n_padded - n_raw, pcm.dtype)])
    # decode-rate quantities (post-decimation when decimate2)
    n = (n_raw + 1) // 2 if decimate2 else n_raw
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    dims = EngineDims.for_waveform(n_padded // rate_mult, fs, cfg.bitrate, npcm)
    power_trig, bit_trig, sos = engine_tables(cfg, fs, dims)

    # integer PCM ships as-is (conditioned on device); floats take the
    # requested compute dtype
    if np.issubdtype(pcm.dtype, np.integer):
        x = jnp.asarray(pcm)
        dtype = jnp.float32
    else:
        x = jnp.asarray(pcm, dtype=dtype)

    decim_sos = (jnp.asarray(iir.design_decim_sos(), dtype)
                 if decimate2 else None)
    out = _fused(x, jnp.asarray(n_raw, jnp.int32),
                 jnp.asarray(power_trig, dtype), jnp.asarray(sos, dtype),
                 jnp.asarray(bit_trig, dtype),
                 **fused_inputs(cfg, fs, dtype),
                 dims=dims, fs=fs, bitrate=float(cfg.bitrate),
                 bit_inset=cfg.bit_inset, edge_pad=100,
                 decimate2=decimate2, decim_sos=decim_sos)
    host = jax.device_get(out)  # the decode's one blocking transfer
    res = finish_result(host, fs_report, n, fs, cfg, wire_used=wire_used)
    if lossy_retry and lossy_retry_worthy(res, n, fs, cfg):
        return decode_waveform_tpu(pcm0, fs0, config=cfg, dtype=dtype,
                                   pad_to_bucket=pad_to_bucket,
                                   mode="monolithic", wire="int8")
    return res


def decode_wav_tpu(path: str, timerange=(0, -1), settings: dict | None = None,
                   compat: str = "strict", wire: str = "auto") -> DecodeResult:
    """Read + decode a WAV with the fused engine.

    int16 mono WAVs ship raw to the device and are conditioned there
    (half the transfer bytes, or a quarter with the int8 wire — see
    ``decode_waveform_tpu``); >50 kHz rates additionally decimate by 2
    on device.  Other encodings go through the host conditioning path."""
    from ..utils.wavio import read_wav, read_wav_raw16

    cfg = resolve_settings(settings, compat=compat)
    raw = read_wav_raw16(path, timerange, allow_highrate=True)
    if raw is not None:
        return decode_waveform_tpu(raw[0], raw[1], config=cfg, wire=wire)
    pcm, fs = read_wav(path, timerange)
    return decode_waveform_tpu(pcm, fs, config=cfg)
