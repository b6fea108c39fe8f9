"""Segmented decode: fixed-shape segment programs + streamed upload.

The monolithic fused engine compiles one program per 15 s length bucket,
whose compile time and device-memory footprint scale with file length
(a >30 min recording is one giant FFT graph, and every new bucket costs
a fresh compile).  This module bounds both:

* **stage 1 runs per ~24 s segment** with a fixed shape shared by every
  file length — one compilation, ever.  Each segment gets a raw left
  halo (IIR ring-in for the overlap-save FFT filter) and right halo
  (power-window straddle + crossing probes), the same halo math as the
  SP time-sharded path (parallel/timeshard.py), but sequential on one
  device instead of parallel over a mesh.  Offline decodes dispatch
  segments in vmapped GROUPS of 4 (see GROUP below) to amortize the
  per-dispatch overhead; the realtime streaming decoder
  (stream_tpu.py) keeps one dispatch per segment, because a push API
  must decode each segment the moment its audio arrives.
* **host->device upload streams per chunk** while earlier chunks
  compute — the dispatch queue is never blocked on the whole file's
  bytes (the transfer link, not compute, bounds single-file latency).
* the variable-size remainder (power smoothing, trigger, bit-edge
  chain, headers, profile) reuses the fused back half; its compile cost
  is bounded by padding the segment count to m*2^e buckets (mantissa
  m in 4..7, _bucket_count), so all file lengths share O(log) assemble
  programs with <= 25% padding.

Segment length is a whole number of power-window strides (keeping the
global 25 Hz window grid aligned across segment boundaries), chosen as
the largest that fits a SEG_NFFT = 2^20-point FFT with halos (~23.6 s
at 44.1 kHz) — see _seg_geometry.  >50 kHz WAVs decimate by 2 on device inside
each segment program (the halos absorb the zero-phase anti-alias
filter's ring), so long high-rate files keep both the streamed raw
upload and the bounded compile.

Decode results match the monolithic engine (same grid, same chain, same
back half); the only numeric difference is the overlap-save filter halo
versus one whole-file FFT (both approximate the same IIR to ~1e-6).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import chain as chain_ops
from ..ops import goertzel, iir
from ..utils.config import DecoderConfig
from . import tpu_engine as eng
from .parity_engine import DecodeResult

SEG_NFFT = 1 << 20          # per-segment FFT size (fixed pow2)
LEFT_HALO = 4096            # raw ring-in for the filter (transient < ~1k)
BIG = np.iinfo(np.int32).max // 2

# Segments per dispatch for offline decodes: vmapped chunks of GROUP
# segments + the chunked assemble amortize per-dispatch overhead.  Not
# yet re-tuned on the GPU; scripts/microbench_resident_group.py A/Bs
# group sizes and checks their numerics.
GROUP = 4


def _seg_geometry(fs: float):
    """Segment geometry: the largest whole-stride segment whose haloed
    extension fits SEG_NFFT exactly (~23.6 s at 44.1 kHz).  Sizing the
    segment to the FFT rather than the FFT to the segment keeps the pow2
    pad waste at <1% (1500 strides paid a 4.19M-point FFT for a 2.65M
    extension, 1.58x the work).  SEG_NFFT = 2^20 is not yet re-tuned on
    the GPU."""
    d_pcm = int(round(fs / 25))
    n_power = int(fs / 10)
    right = n_power  # covers window straddle and crossing-probe lookahead
    strides = (SEG_NFFT - LEFT_HALO - right) // d_pcm
    seg_len = strides * d_pcm
    c_seg = max(int(seg_len / fs * chain_ops.CROSSINGS_PER_SECOND) + 256,
                1024)
    return d_pcm, n_power, seg_len, right, c_seg


def _segment_body(fs: float, npcm: int, bit_inset: int, edge_pad: int,
                  integer_input: bool, decim2: bool, wire4: bool):
    """The fixed-shape stage-1 segment computation: conditioning,
    overlap-save FFT filter, tone powers on the global grid, crossings +
    per-crossing probes.  Shared by the per-segment program (realtime
    stream pushes) and the grouped program (offline decode, GROUP
    segments vmapped into one dispatch).

    With ``decim2`` (>50 kHz WAVs) the segment arrives at 2x the decode
    rate and is conditioned + zero-phase anti-alias decimated on device
    first (the segment form of tpu_engine.decimate2_on_device; the halos
    absorb the filter's symmetric ring).  ``fs`` is always the decode
    (post-decimation) rate; ``n_valid`` and ``k_off`` arrive at the raw
    rate and decode rate respectively."""
    d_pcm, n_power, seg_len, right, c_seg = _seg_geometry(fs)
    ext_len = LEFT_HALO + seg_len + right
    raw_mult = 2 if decim2 else 1
    in_len = ext_len * raw_mult
    nfft = iir.next_pow2(ext_len)

    def segment(seg_ext, dc, peak, k_off, n_valid, ptrig, sos_arr, btrig,
                decim_sos):
        if wire4:
            x = eng.unpack_int4(seg_ext, in_len).astype(jnp.float32)
        elif integer_input:
            x = seg_ext.astype(jnp.float32)
        else:
            x = seg_ext
        gpos_raw = jnp.arange(in_len) + raw_mult * (k_off - LEFT_HALO)
        x = jnp.where((gpos_raw >= 0) & (gpos_raw < n_valid),
                      (x - dc) / peak, 0.0)
        nv_dec = (n_valid + raw_mult - 1) // raw_mult
        if decim2:
            nfft_d = iir.next_pow2(in_len)
            h = eng.sos_response_on_device(decim_sos, nfft_d)
            zero_phase = (h * jnp.conj(h)).real
            spec_d = jnp.fft.rfft(x, nfft_d) * zero_phase
            x = jnp.fft.irfft(spec_d, nfft_d)[:in_len][::2]
            gpos_ext = jnp.arange(ext_len) + (k_off - LEFT_HALO)
            x = jnp.where((gpos_ext >= 0) & (gpos_ext < nv_dec), x, 0.0)

        response = eng.sos_response_on_device(sos_arr, nfft)
        spec = jnp.fft.rfft(x, nfft) * response
        filt = jnp.fft.irfft(spec, nfft)[:ext_len].astype(jnp.float32)

        # tone powers on the global 25 Hz grid (raw; smoothing is global);
        # body length seg_len + n_power gives exactly seg_len/d_pcm windows
        body = x[LEFT_HALO : LEFT_HALO + seg_len + right]
        with jax.named_scope("tone_power"):
            powers = goertzel.framed_tone_power_tiled(body, n_power, d_pcm,
                                                      ptrig)  # (strides, F)

        # crossings within [0, seg_len) local, global-position masked
        fbody = filt[LEFT_HALO:]
        sgn = jnp.where(fbody >= 0, 1, -1)
        is_c = sgn[:seg_len] != sgn[1 : seg_len + 1]
        gpos_blk = jnp.arange(seg_len) + k_off
        is_c &= (gpos_blk >= edge_pad) & (gpos_blk < nv_dec - 1)
        pos, cnt, rovf = chain_ops.compact_indices_rowcap(
            is_c, c_seg, BIG, row_cap=chain_ops.rowcap_for_fs(fs))
        probes = goertzel.tone_power_at(
            fbody, jnp.clip(pos, 0, seg_len - 1) + bit_inset, npcm, btrig)
        gpos = jnp.where(pos < BIG, pos + k_off, BIG).astype(jnp.int32)
        # ONE probe stream ships per crossing: the confidence ratio
        # space/max(mark, eps) carries both the bit decision and the
        # calibration histogram (eng.stage15_core) — half the probe
        # merge traffic and one fewer 660k gather in the assemble
        c0 = probes[:, 1] / jnp.maximum(probes[:, 0], 1e-30)
        # the true crossing count: the assemble program needs it for the
        # ragged merge (> c_seg signals truncation there; rovf flags a
        # row-cap truncation — a 128-sample run denser than the filter's
        # Rice bound — whose entries are missing even when cnt <= c_seg)
        return powers, gpos, c0, cnt, rovf

    return segment


@functools.lru_cache(maxsize=8)
def _segment_program(fs: float, npcm: int, bit_inset: int, edge_pad: int,
                     integer_input: bool, decim2: bool = False,
                     wire4: bool = False):
    """ONE segment per dispatch — the realtime streaming decoder's
    program (stream_tpu.py pushes each segment the moment its audio
    arrives; batching pushes would add ~71 s of receiver latency).
    Offline decodes use _segment_program_grouped instead.  Compiled once
    per (fs, config geometry) for every file."""
    return jax.jit(_segment_body(fs, npcm, bit_inset, edge_pad,
                                 integer_input, decim2, wire4))


@functools.lru_cache(maxsize=8)
def _segment_program_grouped(fs: float, npcm: int, bit_inset: int,
                             edge_pad: int, integer_input: bool,
                             decim2: bool = False, wire4: bool = False):
    """GROUP segments vmapped into one dispatch — the offline decode
    path's stage-1 program."""
    return jax.jit(jax.vmap(
        _segment_body(fs, npcm, bit_inset, edge_pad, integer_input,
                      decim2, wire4),
        in_axes=(0, None, None, 0, None, None, None, None, None)))


def _assemble_body(powers_t, gpos_t, c0_t, cnt_t, rovf_t, n_valid, trig_i,
                   trig_f, hdr_rel, calib_off, coeff_defaults, temp_lut,
                   limits, dims, fs: float, bitrate: float):
    """Shared assemble body (traced inside jit): concatenate per-segment
    outputs, merge crossings, run the bit-edge chain, and hand off to
    the fused device back half.  ``*_t`` are sequences of per-segment
    buffers (rows of a stacked chunk are fine — static slices fuse)."""
    from jax import lax

    # powers: n_seg x (strides, F) -> global smoothed ratios
    with jax.named_scope("tone_power"):
        p = jnp.concatenate(powers_t, axis=0)
        sm = [iir.boxsmooth_lag(p[:, i], 5) for i in range(3)]
        r400 = jnp.log10(sm[0] / sm[2])
        r7500 = jnp.log10(sm[1] / sm[2])

    # Segments are time-ordered and sorted within, and each row's
    # valid prefix length is known (cnt_t) — so the merge is a
    # RAGGED CONCATENATION: ascending fixed-size dynamic_update_slice
    # writes, each overwriting the previous row's BIG tail.  That is
    # ~8 MB of sequential writes, replacing a 2M-element mask
    # compaction + survivor gather and letting the probe table merge
    # alongside so the bit-edge probes gather DIRECTLY (no composed
    # slot re-gather).
    k_seg = len(gpos_t)
    c_seg = gpos_t[0].shape[0]
    m = k_seg * c_seg
    cnt_seg = jnp.stack(cnt_t)
    cnts = jnp.minimum(cnt_seg, c_seg)
    coff = jnp.cumsum(cnts) - cnts
    n_cross = coff[-1] + cnts[-1]
    buf_g = jnp.full((m,), BIG, jnp.int32)
    buf_c0 = jnp.zeros((m,), c0_t[0].dtype)
    for k in range(k_seg):
        at = (coff[k],)
        buf_g = lax.dynamic_update_slice(buf_g, gpos_t[k], at)
        buf_c0 = lax.dynamic_update_slice(buf_c0, c0_t[k], at)
    g_s = jnp.where(jnp.arange(m) < n_cross, buf_g, BIG)

    edge_idx, n_edges = chain_ops.enumerate_bit_edges(
        g_s, n_cross, fs, bitrate, dims.max_edges)
    safe = jnp.clip(edge_idx, 0, m - 1)
    ovf0 = jnp.max(jnp.stack([(cnt_t[k] > c_seg).astype(jnp.int32)
                              | rovf_t[k].astype(jnp.int32)
                              for k in range(k_seg)]))
    return eng.back_half_core(
        r400, r7500, g_s[safe], n_edges, buf_c0[safe],
        n_valid, trig_i, trig_f, hdr_rel, calib_off, coeff_defaults,
        temp_lut, limits, dims, fs, overflow0=ovf0)


@functools.lru_cache(maxsize=8)
def _assemble_program(n_seg: int, dims, fs: float, bitrate: float):
    """Assemble over per-segment outputs passed as TUPLES of individual
    segment buffers (a pytree — jit flattens it), NOT pre-stacked
    arrays: the ragged merge writes each segment's buffer directly into
    the merged table, so the (n_seg, c_seg) stacks never materialize and
    the six eager ``jnp.stack`` dispatches (28 x ~8 MB of device copies
    per decode) disappear from the host loop."""

    def assemble(powers_t, gpos_t, c0_t, cnt_t, rovf_t, n_valid, trig_i,
                 trig_f, hdr_rel, calib_off, coeff_defaults, temp_lut,
                 limits):
        return _assemble_body(powers_t, gpos_t, c0_t, cnt_t, rovf_t,
                              n_valid, trig_i, trig_f, hdr_rel, calib_off,
                              coeff_defaults, temp_lut, limits, dims, fs,
                              bitrate)

    return jax.jit(assemble)


@functools.lru_cache(maxsize=8)
def _assemble_program_chunked(dims, fs: float, bitrate: float):
    """Assemble over CHUNK-STACKED segment outputs: each ``*_c`` input is
    a tuple of arrays with a leading chunk axis (the stacked outputs of a
    vmapped multi-segment dispatch).  Rows are read by static slice
    INSIDE the jit — slicing the stacks eagerly on the host would cost
    one tiny device dispatch per (segment x output), which is exactly
    the overhead grouped dispatch exists to remove."""

    def assemble_chunked(powers_c, gpos_c, c0_c, cnt_c, rovf_c, n_valid,
                         trig_i, trig_f, hdr_rel, calib_off, coeff_defaults,
                         temp_lut, limits):
        def rows(chunks):
            return [c[i] for c in chunks for i in range(c.shape[0])]

        return _assemble_body(rows(powers_c), rows(gpos_c), rows(c0_c),
                              rows(cnt_c), rows(rovf_c), n_valid, trig_i,
                              trig_f, hdr_rel, calib_off, coeff_defaults,
                              temp_lut, limits, dims, fs, bitrate)

    return jax.jit(assemble_chunked)


def _bucket_count(k: int) -> int:
    """Smallest m * 2^e >= k with mantissa m in {4..7} (exact below 4):
    segment counts share O(log) assemble programs (4 per octave, each a
    one-time cached compile) with <= 25% padding.  Pure pow2 padding
    wasted up to 2x — zero-padding segments feed the assemble chain's
    full-table squaring gathers, the decode's most expensive op."""
    if k <= 4:
        return max(k, 1)
    e = 0
    while (k + (1 << e) - 1) >> e > 7:
        e += 1
    return ((k + (1 << e) - 1) >> e) << e


class _DropPlan:
    """Host-side decode plan shared by decode_waveform_segmented and the
    prestaged resident API: the wire-encoded PCM, segment/chunk geometry,
    device-staged constant tables, and the compiled grouped segment +
    chunked assemble programs."""

    __slots__ = ("cfg", "fs", "fs_report", "raw_mult", "n_raw", "n",
                 "seg_len", "right", "w", "pcm", "enc", "n_seg",
                 "n_seg_pad", "n_chunk", "dims", "vseg", "assemble",
                 "params", "pt", "so", "bt", "ds", "dc_d", "peak_d",
                 "nv_raw", "nv_dec", "pk", "buf_len", "fill",
                 "npcm", "integer_input", "decim2", "wire4")


def _plan_waveform(pcm, fs, config, wire, timer) -> _DropPlan:
    """Build the decode plan: resolve the wire + encode on host, fix the
    chunk geometry, stage the constant tables on device, and look up the
    cached programs.  Everything after this is dispatch + fetch."""
    p = _DropPlan()
    cfg = config or DecoderConfig()
    pcm = np.asarray(pcm)
    if pcm.dtype == np.uint8:
        raise ValueError("pass unpacked integer PCM with wire='int4'; "
                         "pre-packed nibble streams lose the sample count")
    # >50 kHz input decimates by 2 on device, per segment; the report
    # prints the halved rate as a float (reference host `fs /= 2`)
    decim2 = float(fs) > 50000.0
    if decim2:
        fs = float(fs) / 2.0
        fs_report = fs
    else:
        fs_report = float(fs) if isinstance(fs, float) else int(fs)
        fs = float(fs)
    raw_mult = 2 if decim2 else 1
    n_raw = int(len(pcm))
    n = (n_raw + raw_mult - 1) // raw_mult  # decode-rate length
    d_pcm, n_power, seg_len, right, c_seg = _seg_geometry(fs)
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset

    integer_input = bool(np.issubdtype(pcm.dtype, np.integer))
    wire4 = False
    enc = None  # chunked int4 encoder (quantizes ahead of the uploads)
    with timer.stage("host_encode_stats"):
        if integer_input:
            from ..ops import wire as wire_ops

            w = wire_ops.resolve_wire(wire, pcm.dtype)
            ext_len_chk = LEFT_HALO + seg_len + right
            if w == "int4" and (seg_len % 2 or ext_len_chk % 2):
                w = "int8"  # packed slicing needs even segment boundaries
            if w == "int4":
                # chunked C encoder: quantize ahead of the upload cursor so
                # the first chunk transfer starts after ~25 ms, with the
                # remaining chunks running under the IO-bound wire drain
                # (closed-form dc/peak — see wire.ChunkedInt4Encoder)
                enc = wire_ops.chunked_int4_encoder(pcm)
                if enc is not None:
                    pcm, dc, peak = enc.packed, enc.dc, enc.peak
                else:  # no native lib: one-shot pack + stats
                    pcm, dc, peak = wire_ops.quantize_int4_packed_stats(pcm)
                wire4 = True
            else:
                pcm = wire_ops.encode(pcm, w)
                dc = float(np.mean(pcm))
                # min/max reductions, not np.abs (wraps at the int16
                # minimum) and no waveform-sized temporary (fresh-page
                # stall — see ops.wire.int4_stats)
                peak = (float(max(int(pcm.max()), -int(pcm.min()), 1))
                        if n_raw else 1.0)
        else:
            w = "float32"  # conditioned float PCM ships verbatim
            dc, peak = 0.0, 1.0  # float input arrives conditioned
            pcm = pcm.astype(np.float32)

    n_seg = max(int(np.ceil(n / seg_len)), 1)
    n_seg_pad = _bucket_count(n_seg)
    dims = eng.EngineDims.for_waveform(n_seg_pad * seg_len, fs, cfg.bitrate,
                                       npcm)
    power_trig, bit_trig, sos = eng.engine_tables(cfg, fs, dims)

    p.vseg = _segment_program_grouped(fs, npcm, cfg.bit_inset, 100,
                                      integer_input, decim2, wire4)
    p.assemble = _assemble_program_chunked(dims, fs, float(cfg.bitrate))
    fused = eng.fused_inputs(cfg, fs)
    p.params = (fused["trig_i"], fused["trig_f"], fused["hdr_rel"],
                fused["calib_off"], fused["coeff_defaults"],
                fused["temp_lut"], fused["limits"])
    p.pt = jnp.asarray(power_trig, jnp.float32)
    p.so = jnp.asarray(sos, jnp.float32)
    p.bt = jnp.asarray(bit_trig, jnp.float32)
    p.ds = jnp.asarray(iir.design_decim_sos() if decim2
                       else np.zeros((1, 6)), jnp.float32)
    p.dc_d = jnp.asarray(np.float32(dc))
    p.peak_d = jnp.asarray(np.float32(peak))
    # raw-rate count for the segment programs (conditioning mask), the
    # decode-rate count for the assemble/back half (its trigger derives
    # the real power-window grid from decode-rate n_power/d_pcm — a raw
    # count would extend it ~2x over bucket padding and could fire the
    # hard-timeout trigger on recordings too short for it)
    p.nv_raw = jnp.asarray(n_raw, jnp.int32)
    p.nv_dec = jnp.asarray(n, jnp.int32)

    ext_len = LEFT_HALO + seg_len + right
    in_len = ext_len * raw_mult
    # packed int4 slices in the byte domain (2 samples/byte; boundaries
    # are even by the geometry check above, only n_raw itself may be odd)
    p.pk = 2 if wire4 else 1
    p.buf_len = in_len // p.pk
    p.fill = np.uint8(0x88) if wire4 else pcm.dtype.type(0)

    p.cfg, p.fs, p.fs_report = cfg, fs, fs_report
    p.raw_mult, p.n_raw, p.n = raw_mult, n_raw, n
    p.seg_len, p.right = seg_len, right
    p.w, p.pcm, p.enc = w, pcm, enc
    p.n_seg, p.n_seg_pad = n_seg, n_seg_pad
    p.n_chunk = (n_seg_pad + GROUP - 1) // GROUP
    p.dims = dims
    p.npcm, p.integer_input = npcm, integer_input
    p.decim2, p.wire4 = decim2, wire4
    return p


def _chunk_host(p: _DropPlan, j: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-build chunk j's (GROUP, buf_len) stacked segment extensions +
    per-row global offsets.  Rows past n_seg are zero segments: any
    content with an offset past n_valid masks to silence (no crossings,
    zero powers — tests/test_segmented.py padding-neutrality)."""
    exts = np.full((GROUP, p.buf_len), p.fill, dtype=p.pcm.dtype)
    koffs = np.empty(GROUP, np.int32)
    for r in range(GROUP):
        k = j * GROUP + r
        koffs[r] = min(k, p.n_seg) * p.seg_len
        if k >= p.n_seg:
            continue
        lo = (k * p.seg_len - LEFT_HALO) * p.raw_mult
        hi = (k * p.seg_len + p.seg_len + p.right) * p.raw_mult
        src_lo, src_hi = max(lo, 0), min(hi, p.n_raw)
        if src_hi > src_lo:
            exts[r, (src_lo - lo) // p.pk
                 : (src_hi - lo + p.pk - 1) // p.pk] = \
                p.pcm[src_lo // p.pk : (src_hi + p.pk - 1) // p.pk]
    return exts, koffs


@functools.lru_cache(maxsize=8)
def _resident_program(n_chunk: int, dims, fs: float, bitrate: float,
                      npcm: int, bit_inset: int, edge_pad: int,
                      integer_input: bool, decim2: bool, wire4: bool):
    """The WHOLE resident decode as ONE dispatch: ``lax.map`` over the
    pre-staged (n_chunk, GROUP, buf_len) chunk stack — keeping the
    per-iteration FFT batch at GROUP — feeding straight into the
    assemble body.  Removes the n_chunk per-chunk dispatch boundaries
    from the decode wall.  Only usable when every chunk is already in
    device memory (the prestaged path): the streamed path needs
    per-chunk dispatches so uploads overlap compute."""
    body = _segment_body(fs, npcm, bit_inset, edge_pad, integer_input,
                         decim2, wire4)
    vbody = jax.vmap(body, in_axes=(0, None, None, 0, None, None, None,
                                    None, None))

    def resident(ext_all, dc, peak, koff_all, nv_raw, nv_dec, ptrig,
                 sos_arr, btrig, decim_sos, trig_i, trig_f, hdr_rel,
                 calib_off, coeff_defaults, temp_lut, limits):
        outs = jax.lax.map(
            lambda xs: vbody(xs[0], dc, peak, xs[1], nv_raw, ptrig,
                             sos_arr, btrig, decim_sos),
            (ext_all, koff_all))

        def rows(a):
            return [a[j, i] for j in range(n_chunk)
                    for i in range(a.shape[1])]

        return _assemble_body(rows(outs[0]), rows(outs[1]), rows(outs[2]),
                              rows(outs[3]), rows(outs[4]), nv_dec,
                              trig_i, trig_f, hdr_rel, calib_off,
                              coeff_defaults, temp_lut, limits, dims, fs,
                              bitrate)

    return jax.jit(resident)


def _dispatch_chunks(p: _DropPlan, chunks, kchunks):
    """Dispatch every staged chunk through the grouped segment program
    and hand the stacked outputs to the chunked assemble; returns the
    assemble's device output (async — nothing has been fetched)."""
    outs = [p.vseg(c, p.dc_d, p.peak_d, k, p.nv_raw, p.pt, p.so, p.bt,
                   p.ds)
            for c, k in zip(chunks, kchunks)]
    return p.assemble(*[tuple(o[i] for o in outs) for i in range(5)],
                      p.nv_dec, *p.params)


def decode_waveform_segmented(pcm, fs, config: DecoderConfig | None = None,
                              dtype=jnp.float32,
                              wire: str = "auto",
                              timer=None,
                              lossy_retry: bool = True) -> DecodeResult:
    """Decode with grouped per-segment stage 1 (streamed upload, bounded
    compile, GROUP segments per dispatch).

    Same result contract as decode_waveform_tpu; integer input is
    conditioned on device with host-computed raw-int DC/peak statistics
    (the same float64 statistics the WAV reader uses).  ``wire`` selects
    the upload format for integer PCM (ops.wire; "auto" = int16).
    ``timer`` (an optional utils.profiling.StageTimer) splits the wall
    into encode / dispatch loop / assemble / fetch / host-finish stages
    for latency triage.
    """
    from ..utils.profiling import StageTimer

    timer = timer if timer is not None else StageTimer()
    p = _plan_waveform(pcm, fs, config, wire, timer)

    # chunk j+1's upload streams while chunk j computes; fully-padded
    # chunks (bucket tail) share one zero upload
    zero_ext = zero_koff = None
    with timer.stage("dispatch_loop"):
        outs = []
        for j in range(p.n_chunk):
            if j * GROUP >= p.n_seg:
                if zero_ext is None:
                    zero_ext = jnp.asarray(
                        np.full((GROUP, p.buf_len), p.fill, p.pcm.dtype))
                    zero_koff = jnp.asarray(
                        np.full(GROUP, p.n_seg * p.seg_len, np.int32))
                ext_arg, koff_arg = zero_ext, zero_koff
            else:
                if p.enc is not None:
                    with timer.stage("  encode_chunks"):
                        last = min(j * GROUP + GROUP, p.n_seg) - 1
                        p.enc.ensure((last * p.seg_len + p.seg_len
                                      + p.right) * p.raw_mult)
                with timer.stage("  build_upload"):
                    exts, koffs = _chunk_host(p, j)
                    ext_arg = jnp.asarray(exts)
                    koff_arg = jnp.asarray(koffs)
            outs.append(p.vseg(ext_arg, p.dc_d, p.peak_d, koff_arg,
                               p.nv_raw, p.pt, p.so, p.bt, p.ds))

    with timer.stage("assemble_dispatch"):
        out = p.assemble(*[tuple(o[i] for o in outs) for i in range(5)],
                         p.nv_dec, *p.params)
    with timer.stage("fetch"):
        host = jax.device_get(out)  # the decode's one blocking transfer
    with timer.stage("host_finish"):
        res = eng.finish_result(host, p.fs_report, p.n, p.fs, p.cfg,
                                wire_used=p.w)
    # degenerate int4-wire decode: one lossless retry (the noise-shaped
    # wire's content-dependent calibration cliff — eng.lossy_retry_worthy)
    if lossy_retry and eng.lossy_retry_worthy(res, p.n, p.fs, p.cfg):
        return decode_waveform_segmented(pcm, fs, config=p.cfg, dtype=dtype,
                                         wire="int8", timer=timer)
    return res


class PrestagedDrop:
    """A drop staged for device-resident decode: every grouped segment
    buffer already in device memory, the constant tables staged, the
    programs compiled.  ``decode()`` then measures/ships pure device
    capability — segment dispatches + assemble + one packed-result fetch
    — with no wire upload in the loop.  This is the steady state of
    corpus jobs that keep hot drops resident, and the surface bench.py's
    resident child measures.
    """

    def __init__(self, plan: _DropPlan, chunks, kchunks,
                 fused: bool = False):
        self.plan = plan
        self.chunks = chunks
        self.kchunks = kchunks
        self.fused = fused
        if fused:  # one (n_chunk, GROUP, buf_len) stack, one dispatch
            self.ext_all = jnp.stack(chunks)
            self.koff_all = jnp.stack(kchunks)
            p = plan
            self._prog = _resident_program(
                p.n_chunk, p.dims, p.fs, float(p.cfg.bitrate), p.npcm,
                p.cfg.bit_inset, 100, p.integer_input, p.decim2, p.wire4)

    def dispatch(self):
        """Queue the full decode; returns the assemble's device output
        without blocking (back-to-back dispatches pipeline: decode i's
        result fetch rides under decode i+1's compute)."""
        p = self.plan
        if self.fused:
            return self._prog(self.ext_all, p.dc_d, p.peak_d,
                              self.koff_all, p.nv_raw, p.nv_dec, p.pt,
                              p.so, p.bt, p.ds, *p.params)
        return _dispatch_chunks(p, self.chunks, self.kchunks)

    def finish(self, out) -> DecodeResult:
        """Fetch + host-finish a ``dispatch()`` output."""
        p = self.plan
        return eng.finish_result(jax.device_get(out), p.fs_report, p.n,
                                 p.fs, p.cfg, wire_used=p.w)

    def decode(self) -> DecodeResult:
        return self.finish(self.dispatch())


def prestage_waveform(pcm, fs, config: DecoderConfig | None = None,
                      wire: str = "int8",
                      fused: bool = False) -> PrestagedDrop:
    """Encode + upload every segment chunk of ``pcm`` to the device and
    block until staged; the returned PrestagedDrop decodes with zero
    host->device traffic (one ~245 KB packed result comes back per
    decode).  Default wire is int8 — resident decode is compute-bound,
    so the upload saving of int4 buys nothing once staged.  ``fused``
    runs the whole decode as ONE device dispatch (_resident_program)
    instead of n_chunk+1 — no per-chunk dispatch overhead, at the cost
    of a one-time extra compile."""
    from ..utils.profiling import StageTimer

    p = _plan_waveform(pcm, fs, config, wire, StageTimer())
    if p.enc is not None:
        p.enc.ensure(p.n_raw)
    chunks, kchunks = [], []
    for j in range(p.n_chunk):
        exts, koffs = _chunk_host(p, j)
        chunks.append(jax.device_put(jnp.asarray(exts)))
        kchunks.append(jax.device_put(jnp.asarray(koffs)))
    for c in chunks + kchunks:
        c.block_until_ready()
    return PrestagedDrop(p, chunks, kchunks, fused=fused)
