"""Push-based streaming decode over the segmented device machinery.

The reference's entire design rationale is realtime receiver embedding
(reference README.md:130; the ``keepgoing`` kill-flag and sleep-yield
hooks at AXCTDprocessor.py:119,283,338) — models.stream delivers that
push API with the byte-exact parity engine (host float64).  This module
is the *throughput* variant: the same fixed-shape per-segment stage-1
programs the offline segmented decoder uses (models.segmented), driven
incrementally.

How it maps onto the segmented engine:

* ``feed()`` accumulates PCM; whenever a full segment (plus its right
  halo) is buffered, that segment's fixed-shape stage-1 program is
  dispatched **asynchronously** — per-segment latency is one segment
  dispatch, and the host never re-processes old audio;
* ``results()`` runs the (cheap, compile-cached) assemble/back-half
  program over the segments dispatched so far and returns a full
  DecodeResult snapshot — headers, trigger state, and profile rows all
  re-derive from the accumulated device tables, so rows appear
  incrementally as segments complete;
* ``finalize()`` flushes the partial tail segment with true end-of-data
  masking and returns a result **identical to the offline segmented
  decode** of the concatenated stream (same programs, same inputs).

Interior segments pass an effectively-infinite valid length to the
segment program: their validity masks cannot bind (a segment is only
dispatched once all of its haloed extension is real data), so outputs
equal the offline decode's, which passes the file length to every
segment.  Only the tail segments at ``finalize()`` need the true count.

Input contract matches models.stream: float PCM from a receiver front
end (the decoder's tone-power ratios and bit decisions are scale-free;
DC removal is the receiver's file-conditioning step, not a decoder
requirement).  >50 kHz feeds decimate by 2 on device inside each
segment program, exactly like the offline paths.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import iir
from ..utils.config import DecoderConfig
from . import segmented as seg
from . import tpu_engine as eng
from .parity_engine import DecodeResult

BIG_N = np.int32(2 ** 30)  # "no end in sight" valid-length for interior segs


class TPUStreamDecoder:
    """Incremental AXCTD decoder: the segmented engine fed push-style."""

    def __init__(self, fs, config: DecoderConfig | None = None,
                 max_duration: float | None = None):
        """``max_duration`` (seconds) pins + pre-warms the decode programs
        for a stream up to that length: every ``results()`` snapshot
        assembles at ONE max-size bucket, compiled (and first-D2H-warmed)
        HERE, so no snapshot ever stalls on a fresh XLA compile mid-drop
        (a stall a live receiver cannot absorb).  Streams may still run
        past ``max_duration``; only then do larger buckets compile on
        demand.  Without it,
        snapshots grow through the O(log) bucket ladder, compiling each
        size the first time it is hit (fine offline, where the
        persistent compile cache has already seen every bucket)."""
        self.cfg = config or DecoderConfig()
        self._fs_in = fs
        self._decim2 = float(fs) > 50000.0
        self.fs = float(fs) / 2.0 if self._decim2 else float(fs)
        self._fs_report = (self.fs if self._decim2
                          else (float(fs) if isinstance(fs, float) else int(fs)))
        self._raw_mult = 2 if self._decim2 else 1

        cfg = self.cfg
        self._d_pcm, self._n_power, self._seg_len, self._right, _ = \
            seg._seg_geometry(self.fs)
        self._npcm = int(np.round(self.fs / cfg.bitrate
                                  * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
        self._seg_fn = seg._segment_program(self.fs, self._npcm,
                                            cfg.bit_inset, 100,
                                            integer_input=False,
                                            decim2=self._decim2)
        power_trig, bit_trig, sos = eng.engine_tables(
            cfg, self.fs,
            eng.EngineDims.for_waveform(self._seg_len, self.fs, cfg.bitrate,
                                        self._npcm))
        self._pt = jnp.asarray(power_trig, jnp.float32)
        self._so = jnp.asarray(sos, jnp.float32)
        self._bt = jnp.asarray(bit_trig, jnp.float32)
        self._ds = jnp.asarray(iir.design_decim_sos() if self._decim2
                               else np.zeros((1, 6)), jnp.float32)
        self._one = jnp.asarray(np.float32(1.0))
        self._zero = jnp.asarray(np.float32(0.0))

        self._ext_len = seg.LEFT_HALO + self._seg_len + self._right
        self._in_len = self._ext_len * self._raw_mult

        # rolling raw buffer: samples [self._pend_at, self._fed)
        self._pend = np.zeros(0, np.float32)
        self._pend_at = 0
        self._fed = 0
        self._outs: list = []     # per-segment async device outputs
        self._next_k = 0          # first segment not yet dispatched
        self._finalized = False
        self._consumed_rows = 0

        self._pin_bucket = 0
        if max_duration is not None:
            n_seg_max = max(int(np.ceil(max_duration * self.fs
                                        / self._seg_len)), 1)
            self._pin_bucket = seg._bucket_count(n_seg_max)
            # compile + execute the two programs a snapshot needs (the
            # zero-segment stage-1 program and the pinned assemble), and
            # force the fetch, so the first real snapshot pays no
            # first-transfer cost either
            self._assemble(0, 0)

    # -- feeding -----------------------------------------------------------

    def feed(self, samples) -> int:
        """Push a block of float PCM; dispatches every segment whose full
        haloed extension is now buffered (async — does not block on the
        device).  Returns the number of segments dispatched so far."""
        if self._finalized:
            raise RuntimeError("decoder already finalized")
        x = np.asarray(samples, np.float32).reshape(-1)
        if len(x):
            self._pend = np.concatenate([self._pend, x])
            self._fed += len(x)
        rm = self._raw_mult
        while self._fed >= ((self._next_k + 1) * self._seg_len
                            + self._right) * rm:
            self._dispatch(self._next_k, BIG_N)
            self._next_k += 1
            # drop raw samples no later segment's left halo can reach
            keep_from = max((self._next_k * self._seg_len - seg.LEFT_HALO)
                            * rm, 0)
            if keep_from > self._pend_at:
                self._pend = self._pend[keep_from - self._pend_at:]
                self._pend_at = keep_from
        return self._next_k

    def _dispatch(self, k: int, n_valid) -> None:
        rm = self._raw_mult
        lo = (k * self._seg_len - seg.LEFT_HALO) * rm
        hi = (k * self._seg_len + self._seg_len + self._right) * rm
        ext = np.zeros(self._in_len, np.float32)
        src_lo, src_hi = max(lo, 0), min(hi, self._fed)
        if src_hi > src_lo:
            ext[src_lo - lo: src_hi - lo] = \
                self._pend[src_lo - self._pend_at: src_hi - self._pend_at]
        self._outs.append(self._seg_fn(
            jnp.asarray(ext), self._zero, self._one,
            jnp.asarray(k * self._seg_len, jnp.int32),
            jnp.asarray(n_valid, jnp.int32),
            self._pt, self._so, self._bt, self._ds))

    # -- reading -----------------------------------------------------------

    def _assemble(self, n_seg: int, nv_dec: int) -> DecodeResult:
        cfg = self.cfg
        n_seg = max(n_seg, 1)
        n_seg_pad = max(seg._bucket_count(n_seg), self._pin_bucket)
        dims = eng.EngineDims.for_waveform(n_seg_pad * self._seg_len,
                                           self.fs, cfg.bitrate, self._npcm)
        outs = list(self._outs[:n_seg])
        while len(outs) < n_seg_pad:  # shared zero pad segment
            if not hasattr(self, "_zero_out"):
                zero_ext = jnp.asarray(np.zeros(self._in_len, np.float32))
                self._zero_out = self._seg_fn(
                    zero_ext, self._zero, self._one,
                    jnp.asarray(n_seg * self._seg_len, jnp.int32),
                    jnp.asarray(0, jnp.int32),
                    self._pt, self._so, self._bt, self._ds)
            outs.append(self._zero_out)

        assemble = seg._assemble_program(n_seg_pad, dims, self.fs,
                                         float(cfg.bitrate))
        params = eng.fused_inputs(cfg, self.fs)
        out = assemble(*[tuple(o[i] for o in outs) for i in range(5)],
                       jnp.asarray(nv_dec, jnp.int32),
                       params["trig_i"], params["trig_f"], params["hdr_rel"],
                       params["calib_off"], params["coeff_defaults"],
                       params["temp_lut"], params["limits"])
        host = jax.device_get(out)
        return eng.finish_result(host, self._fs_report, nv_dec, self.fs, cfg,
                                 wire_used="float32")

    def results(self) -> DecodeResult:
        """Snapshot of everything decodable from complete segments so far
        (one assemble dispatch over the accumulated device tables)."""
        covered = self._next_k * self._seg_len  # decode-rate samples done
        return self._assemble(self._next_k, covered)

    def latest_rows(self) -> list[dict]:
        """Profile rows appended since the last call (for live display).

        Each call runs one assemble snapshot; poll at UI rate, not per
        feed."""
        res = self.results() if not self._finalized else self._final
        new = [
            {"time": res.time[i], "depth": res.depth[i],
             "temperature": res.temperature[i],
             "conductivity": res.conductivity[i],
             "salinity": res.salinity[i],
             "r400": res.r400[i], "r7500": res.r7500[i]}
            for i in range(self._consumed_rows, len(res.time))
        ]
        self._consumed_rows = len(res.time)
        return new

    def finalize(self) -> DecodeResult:
        """End of stream: flush the partial tail segment(s) with true
        end-of-data masking.  The result is identical to the offline
        ``decode_waveform_segmented`` of the whole stream."""
        if self._finalized:
            return self._final
        self._finalized = True
        rm = self._raw_mult
        n_raw = self._fed
        n_dec = (n_raw + rm - 1) // rm
        n_seg = max(int(np.ceil(n_dec / self._seg_len)), 1)
        while self._next_k < n_seg:
            self._dispatch(self._next_k, n_raw)
            self._next_k += 1
        self._final = self._assemble(n_seg, n_dec)
        return self._final
