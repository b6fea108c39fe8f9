"""Reference-exact streaming AXCTD decoder (host float64).

This engine reproduces the upstream processor's chunked state machine —
and therefore its byte-identical ``output.txt`` — while the fused engine
(models.tpu_engine) is the throughput path.  Chunking is semantic, not
just an implementation detail (SURVEY.md 3.6): the tone-power window grid
restarts at each chunk start, the demodulation filter state resets per
chunk, and per-bit signal levels are tagged against the current chunk's
windows only; once demodulation begins, chunk starts are bit-aligned and
thus data-dependent.  A whole-waveform pass cannot reproduce those
values, so parity mode keeps the loop.

State-machine contract (reference AXCTDprocessor.py:267-627):

* status 0: scan smoothed 400 Hz/dead power ratio for the first pulse;
* status 1: establish the 7500 Hz baseline 4.5-5.5 s after the pulse,
  demodulate continuously, calibrate the bit-decision scale from header
  1's confidence ratios, decode headers 2 (10.5-14.8 s) and 3 (20-24.5 s)
  for metadata + conversion coefficients;
* status 2 (first new-window 7500 Hz ratio >= baseline + threshold, no
  earlier than 30 s after the pulse): frame-sync the bitstream, convert
  to T/C/S/z, QC, accumulate.

Faithfully preserved quirks (each load-bearing for output parity):

* ``binary_buffer_inds`` receives *every* chained bit edge while
  ``binary_buffer`` receives one fewer bit per chunk (the final edge's
  bit is emitted next chunk), so the index/level buffers accumulate one
  duplicated entry per chunk and bit->time association drifts
  (AXCTDprocessor.py:411-429);
* the confidence buffer is never trimmed after profile parsing
  (AXCTDprocessor.py:617-621);
* ``hexframes`` bypasses both QC filters (AXCTDprocessor.py:576-612);
* live zcoeff adoption is gated on tcoeff validity (models.metadata);
* the per-window tone powers are re-smoothed in place, so each chunk's
  smoothing window spans already-smoothed history plus raw new values
  (AXCTDprocessor.py:367-369 with demodulate.boxsmooth_lag).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.config import DecoderConfig, resolve_settings
from ..utils.lut import load_temp_lut
from ..utils.wavio import read_wav
from . import convert, demod, frames
from . import metadata as md


@dataclasses.dataclass
class DecodeResult:
    """Everything the report writer and downstream consumers need."""

    fs: float
    numpoints: int
    firstpulse400: int = -1
    profstartind: int = -1
    firstpointtime: float = -1.0
    status: int = 0
    metadata: dict = dataclasses.field(default_factory=md.new_metadata)
    time: list = dataclasses.field(default_factory=list)
    r400: list = dataclasses.field(default_factory=list)
    r7500: list = dataclasses.field(default_factory=list)
    depth: list = dataclasses.field(default_factory=list)
    temperature: list = dataclasses.field(default_factory=list)
    conductivity: list = dataclasses.field(default_factory=list)
    salinity: list = dataclasses.field(default_factory=list)
    hexframes: list = dataclasses.field(default_factory=list)
    # hex of only the QC-passing frames, aligned with the row lists above.
    # (`hexframes` bypasses QC — upstream quirk kept for report parity —
    # so it can misalign with the profile rows; this field doesn't.)
    hexframes_qc: list = dataclasses.field(default_factory=list)
    # resolved host->device wire format ("int16"/"int8"/"int4"/"float32");
    # None on the host parity path.  Recorded so a decode is attributable
    # — surfaces in the archive manifest and the --diagnostics report
    # settings echo.
    wire: str | None = None
    # Fused-engine truncation indicator (0 = clean): bit 0 crossings hit
    # the Rice-rate capacity, bit 1 bit-edge table full, bit 2 frame-sync
    # accept compaction overflowed, bit 3 frame table full.  Degradation
    # is graceful (excess entries drop), but a clipped decode must be
    # distinguishable from a clean one.  Always 0 on the parity path
    # (host buffers grow dynamically).
    overflow: int = 0


class ParityDecoder:
    """Streaming AXCTD decoder with upstream-exact chunk semantics."""

    def __init__(self, pcm: np.ndarray | None, fs,
                 config: DecoderConfig | None = None, progress=None):
        self.cfg = config or DecoderConfig()
        # pcm=None starts an empty decoder for push-based streaming (feed())
        self.pcm = np.zeros(0, dtype=np.float64) if pcm is None else np.asarray(pcm)
        self.fs = fs
        self.numpoints = len(self.pcm)
        self.progress = progress
        cfg = self.cfg

        # derived constants (reference initialize_AXCTD_vars / load_AXCTD_settings)
        self.power_rate = 25                      # tone-power probes per second
        self.n_power = int(self.fs / 10)          # samples per power window
        self.smooth_window = 5
        self.d_pcm = int(np.round(self.fs / self.power_rate))
        self.edge_pad = 100                       # demod_Npad
        n = int(np.round(self.fs / cfg.bitrate * (1 - cfg.phase_error / 100)))
        self.npcm = n - 2 * cfg.bit_inset
        if cfg.points_per_loop is not None:
            self.points_per_loop = cfg.points_per_loop
        else:
            self.points_per_loop = int(cfg.refresh_rate * self.fs)

        self.sos = demod.design_filter(self.fs, cfg.use_bandpass)
        self.bit_trig = demod.make_bit_trig(self.fs, cfg.mark_freq, cfg.space_freq,
                                            self.npcm)
        k = 2 * np.pi * np.arange(0, self.n_power) / self.fs
        self.power_trig = {
            "400": (np.cos(k * 400), np.sin(k * 400)),
            "7500": (np.cos(k * 7500), np.sin(k * 7500)),
            "dead": (np.cos(k * cfg.dead_freq), np.sin(k * cfg.dead_freq)),
        }
        self.temp_lut = load_temp_lut()

        # decoder state
        self.result = DecodeResult(fs=fs, numpoints=self.numpoints)
        self._start = 0
        self.status = 0
        self.p400 = np.array([])
        self.p7500 = np.array([])
        self.pdead = np.array([])
        self.r400 = np.array([])
        self.r7500 = np.array([])
        self.power_inds: list = []
        self.firstpulse400 = -1
        self.profstartind = -1
        self.firstpointtime = -1.0
        self.mean7500 = np.nan
        self.high_bit_scale = 1.5
        self.next_demod_start = 0
        self.past_headers = False
        self.header_read = [False, False, False]
        self.live_coeffs = {
            "tcoeff": list(cfg.tcoeff_default),
            "ccoeff": list(cfg.ccoeff_default),
            "zcoeff": list(cfg.zcoeff_default),
        }
        # demodulated-bit buffers (python lists to mirror upstream
        # extend/trim semantics exactly, including the length quirks)
        self.bits: list = []
        self.bit_inds: list = []
        self.bit_conf: list = []
        self.bit_r400: list = []
        self.bit_r7500: list = []

    # ------------------------------------------------------------------
    # main loop — shared by whole-file run() and push-based streaming
    # ------------------------------------------------------------------
    def run(self) -> DecodeResult:
        self._drain(final=True)
        return self._snapshot()

    def feed(self, samples) -> DecodeResult:
        """Push PCM samples (realtime/streaming mode) and process every
        complete loop chunk now available.  Returns the running result."""
        samples = np.asarray(samples, dtype=self.pcm.dtype)
        self.pcm = np.concatenate([self.pcm, samples])
        self.numpoints = len(self.pcm)
        self._drain(final=False)
        return self._snapshot()

    def finalize(self) -> DecodeResult:
        """Signal end-of-stream: process the remaining (clamped) chunks
        with the exact end-of-file semantics of the batch path."""
        self._drain(final=True)
        return self._snapshot()

    def _drain(self, final: bool) -> None:
        while True:
            start = self._start
            end = start + self.points_per_loop
            if final:
                if self.numpoints - start < 4 * self.n_power:
                    if self.progress:
                        self.progress(100)
                    break
                if end >= self.numpoints:
                    end = self.numpoints - 1
            elif end >= self.numpoints:
                # a full chunk is processed mid-stream only once data
                # extends *past* it (the batch loop clamps the final
                # chunk to numpoints-1; that decision waits for EOF)
                break
            if self.progress:
                self.progress(round(100 * start / self.numpoints))

            self._iterate(self.pcm[start:end], start, end)

            if self.status > 0:
                if self.next_demod_start > self.edge_pad:
                    self._start += self.next_demod_start - self.edge_pad
                else:
                    # upstream adds a float here and crashes on the next
                    # slice (SURVEY.md 2.3 #6); we advance one whole bit
                    self._start += int(self.fs / self.cfg.bitrate)
            else:
                self._start = end

    # ------------------------------------------------------------------
    # checkpoint / resume — the decoder state is explicit, so snapshots
    # are a straight serialization (the upstream design's implicit
    # promise, SURVEY.md 5, made real)
    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        import pickle

        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)
        import os

        os.replace(tmp, path)

    @staticmethod
    def load_checkpoint(path: str) -> "ParityDecoder":
        import pickle

        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, ParityDecoder):
            raise TypeError(f"not a decoder checkpoint: {type(obj)}")
        return obj

    def _snapshot(self) -> DecodeResult:
        res = self.result
        res.fs = self.fs
        res.numpoints = self.numpoints
        res.status = self.status
        res.firstpulse400 = self.firstpulse400
        res.profstartind = self.profstartind
        res.firstpointtime = self.firstpointtime
        return res

    # ------------------------------------------------------------------
    # per-chunk pipeline
    # ------------------------------------------------------------------
    def _iterate(self, buffer: np.ndarray, start: int, end: int) -> None:
        pstart = len(self.power_inds)
        self._probe_tone_powers(buffer, start, end, pstart)

        if self.status == 0:
            hits = np.flatnonzero(self.r400[pstart:] >= self.cfg.min_r400)
            if hits.size:
                self.firstpulse400 = self.power_inds[pstart:][hits[0]]
                self.status = 1

        if self.status >= 1:
            self._update_baseline_and_trigger(pstart)
            self._demodulate_chunk(buffer, start, pstart)

        if self.status >= 1 and not self.past_headers:
            self._process_headers()

        if self.status == 2:
            self._parse_profile()

    # -- stage A/B: tone powers + smoothing + ratios ---------------------
    def _probe_tone_powers(self, buffer, start, end, pstart) -> None:
        new_inds = list(range(start, end - self.n_power, self.d_pcm))
        self.power_inds.extend(new_inds)

        raw = {"400": [], "7500": [], "dead": []}
        for ind in new_inds:
            w = buffer[ind - start : ind - start + self.n_power]
            for key, (cos_t, sin_t) in self.power_trig.items():
                raw[key].append(np.abs(np.sum(w * cos_t + 1j * w * sin_t)))

        self.p400 = self._smooth_append(self.p400, raw["400"], pstart)
        self.p7500 = self._smooth_append(self.p7500, raw["7500"], pstart)
        self.pdead = self._smooth_append(self.pdead, raw["dead"], pstart)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.r400 = np.append(self.r400, np.log10(self.p400[pstart:] / self.pdead[pstart:]))
            self.r7500 = np.append(self.r7500, np.log10(self.p7500[pstart:] / self.pdead[pstart:]))

    def _smooth_append(self, smoothed_prev, raw_new, pstart) -> np.ndarray:
        """Lagging box smoother applied incrementally over the stored
        (already-smoothed) history plus this chunk's raw powers."""
        arr = np.append(smoothed_prev, raw_new)
        out = arr.copy()
        w = self.smooth_window
        for i in range(pstart, len(arr)):
            lo = 0 if i < w else i - w
            out[i] = np.nanmean(arr[lo : i + 1])
        return out

    # -- stage C/D: 7500 Hz baseline, profile trigger, demodulation ------
    def _update_baseline_and_trigger(self, pstart) -> None:
        fs, cfg = self.fs, self.cfg
        if (self.power_inds[-1] >= self.firstpulse400 + int(fs * 5.5)
                and np.isnan(self.mean7500)):
            inds = np.asarray(self.power_inds)
            s = np.argmin(np.abs(self.firstpulse400 + int(fs * 4.5) - inds))
            e = np.argmin(np.abs(self.firstpulse400 + int(fs * 5.5) - inds))
            with np.errstate(invalid="ignore"):
                self.mean7500 = np.nanmean(self.r7500[s:e]) if e > s else np.nan

        if self.power_inds[-1] > self.firstpulse400 + int(cfg.trigger_range[0] * fs):
            tone_path = not np.isnan(self.mean7500) and self.status == 1
            if tone_path:
                hits = np.flatnonzero(self.r7500[pstart:] - self.mean7500 >= cfg.min_dr7500)
                if hits.size:
                    self.profstartind = self.power_inds[pstart:][hits[0]]
                    self.status = 2
            # upstream's elif makes the hard timeout unreachable whenever a
            # baseline exists; fixed mode lets -b work as documented
            if (self.status == 1 and cfg.trigger_range[1] > 0
                    and (cfg.compat == "fixed" or not tone_path)
                    and self.power_inds[-1]
                    >= self.firstpulse400 + int(fs * cfg.trigger_range[1])):
                self.profstartind = self.firstpulse400 + int(fs * cfg.trigger_range[1])
                self.status = 2
            if self.profstartind > 0 and self.firstpointtime <= 0:
                self.firstpointtime = self.profstartind / fs

    def _demodulate_chunk(self, buffer, start, pstart) -> None:
        r = demod.demodulate_chunk(
            buffer, self.fs, self.edge_pad, self.sos, self.cfg.bitrate,
            self.bit_trig, self.npcm, self.cfg.bit_inset, self.high_bit_scale,
        )
        self.next_demod_start = r.next_start
        self.bits.extend(r.bits)
        self.bit_conf.extend(r.conf)
        # note: *all* edges, one more than bits — upstream quirk, kept
        new_inds = [e + start for e in r.bit_edges]
        self.bit_inds.extend(new_inds)

        recent_r400 = self.r400[pstart:]
        recent_r7500 = self.r7500[pstart:]
        recent_pw = np.asarray(self.power_inds[pstart:])
        nearest = [int(np.argmin(np.abs(recent_pw - ci))) for ci in new_inds]
        self.bit_r400.extend(recent_r400[j] for j in nearest)
        self.bit_r7500.extend(recent_r7500[j] - self.mean7500 for j in nearest)

    # -- stage E: header windows ----------------------------------------
    def _process_headers(self) -> None:
        fs = self.fs
        first_bit, last_bit = self.bit_inds[0], self.bit_inds[-1]
        ind_arr = np.asarray(self.bit_inds)
        margin = int(fs * 0.5)
        headers: list = [None, None]

        # header 1 (2.3-3.3 s post-pulse): scale-factor calibration only
        h1s = self.firstpulse400 + int(fs * 2.3)
        h1e = self.firstpulse400 + int(fs * 3.3)
        if first_bit <= h1s and last_bit >= h1e and not self.header_read[0]:
            lo = np.flatnonzero(ind_arr >= h1s - margin)[0]
            hi = np.flatnonzero(ind_arr <= h1e + margin)[-1]
            self.high_bit_scale = demod.calibrate_scale_factor(
                self.bit_conf[lo:hi], self.high_bit_scale)
            self.header_read[0] = True

        # headers 2 and 3: full metadata decode
        for slot, (ws, we) in enumerate(((10.5, 14.8), (20.0, 24.5)), start=1):
            hs = self.firstpulse400 + int(fs * ws)
            he = self.firstpulse400 + int(fs * we)
            if first_bit <= hs and last_bit >= he and not self.header_read[slot]:
                lo = np.flatnonzero(ind_arr >= hs - margin)[0]
                hi = np.flatnonzero(ind_arr <= he + margin)[-1]
                header_bits = frames.trim_header(self.bits[lo:hi])
                if len(header_bits) >= 72 * 32:
                    headers[slot - 1] = frames.parse_header(header_bits)
                    self.header_read[slot] = True

        md.merge_headers(self.result.metadata, headers[0], headers[1],
                         self.live_coeffs)

    # -- stage F: profile frame parse + convert + QC ---------------------
    def _parse_profile(self) -> None:
        self.past_headers = True
        cfg, fs = self.cfg, self.fs

        if self.bit_inds[0] <= self.profstartind:
            first = np.flatnonzero(np.asarray(self.bit_inds) > self.profstartind)[0]
            self.bits = self.bits[first:]
            self.bit_inds = self.bit_inds[first:]
            self.bit_conf = self.bit_conf[first:]
            self.bit_r400 = self.bit_r400[first:]
            self.bit_r7500 = self.bit_r7500[first:]

        bit_times = (np.asarray(self.bit_inds) - self.profstartind) / fs
        starts, consumed = frames.sync_profile_frames(self.bits, self.bit_r7500)

        if starts.size:
            bits_arr = np.asarray(self.bits, dtype=np.int64)
            frame_bits = bits_arr[starts[:, None] + np.arange(32)]
            tint, cint = convert.frame_ints(frame_bits)
            times_raw = bit_times[starts]
            temps, conds, psals, depths = convert.ints_to_observations(
                tint, cint, times_raw, self.temp_lut,
                self.live_coeffs["tcoeff"], self.live_coeffs["ccoeff"],
                self.live_coeffs["zcoeff"],
            )
            hexframes = [self._frame_hex(fb) for fb in frame_bits]

            times = np.round(times_raw + self.firstpointtime, 2)
            depths = np.round(depths, 2)
            temps = np.round(temps, 2)
            conds = np.round(conds, 2)
            psals = np.round(psals, 2)
            r400 = np.round(np.asarray(self.bit_r400)[starts], 2)
            r7500 = np.round(np.asarray(self.bit_r7500)[starts], 2)

            hexframes_arr = np.asarray(hexframes, dtype=object)
            good = convert.qc_bounds_mask(r400, r7500, temps, psals, cfg)
            times, depths, temps = times[good], depths[good], temps[good]
            conds, psals = conds[good], psals[good]
            r400, r7500 = r400[good], r7500[good]
            hexframes_arr = hexframes_arr[good]

            if len(temps) > 0:
                good = convert.qc_spike_mask(temps, psals)
                times, depths, temps = times[good], depths[good], temps[good]
                conds, psals = conds[good], psals[good]
                r400, r7500 = r400[good], r7500[good]
                hexframes_arr = hexframes_arr[good]

                if len(temps) > 0:
                    res = self.result
                    res.time.extend(times)
                    res.r400.extend(r400)
                    res.r7500.extend(r7500)
                    res.depth.extend(depths)
                    res.temperature.extend(temps)
                    res.conductivity.extend(conds)
                    res.salinity.extend(psals)
                    # hexframes deliberately unfiltered (upstream quirk)
                    res.hexframes.extend(hexframes)
                    res.hexframes_qc.extend(hexframes_arr)

        self.bits = self.bits[consumed:]
        self.bit_inds = self.bit_inds[consumed:]
        self.bit_r400 = self.bit_r400[consumed:]
        self.bit_r7500 = self.bit_r7500[consumed:]
        # bit_conf intentionally not consumed (upstream quirk)

    @staticmethod
    def _frame_hex(frame_bits) -> str:
        from ..ops.bits import bits_to_hex_np

        return bits_to_hex_np(frame_bits)


def decode_waveform(pcm, fs, config: DecoderConfig | None = None,
                    progress=None) -> DecodeResult:
    """Decode a conditioned waveform with the parity engine."""
    return ParityDecoder(pcm, fs, config=config, progress=progress).run()


def decode_wav(path: str, timerange=(0, -1), settings: dict | None = None,
               compat: str = "strict", progress=None) -> DecodeResult:
    """Read + condition + decode a WAV file end to end."""
    pcm, fs = read_wav(path, timerange)
    cfg = resolve_settings(settings, compat=compat)
    return decode_waveform(pcm, fs, config=cfg, progress=progress)
