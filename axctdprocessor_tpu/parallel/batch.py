"""Batched multi-drop decode — vmap over drops, data-parallel over a mesh.

This is the archive-reprocessing path (BASELINE.json: "64 WAV drops
vmapped through the fused demod+parse pipeline").  The fused engine's
whole decode program (front end + trigger + headers + profile) is
vmapped over the batch dimension and, when a mesh is given, sharded over
its ``dp`` axis so XLA runs each drop's decode on its own device slice
with zero cross-device traffic (drops are independent).  The entire
batch is one dispatch and one blocking device->host transfer; the host
only reconstructs metadata and formats reports.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import tpu_engine as eng
from ..models.parity_engine import DecodeResult
from ..utils.config import DecoderConfig


def pad_to_multiple(batch_arrays: list[np.ndarray], m: int):
    """Pad every array's leading dim up to a multiple of m (repeating row 0).

    Returns (padded arrays, original batch size).  Used to satisfy mesh
    divisibility; padded rows' outputs are discarded by the caller.
    """
    b = batch_arrays[0].shape[0]
    b_pad = int(np.ceil(b / m)) * m
    if b_pad == b:
        return batch_arrays, b
    out = []
    for a in batch_arrays:
        reps = np.repeat(a[:1], b_pad - b, axis=0)
        out.append(np.concatenate([a, reps], axis=0))
    return out, b


def pad_batch(pcms: list[np.ndarray], dtype=None) -> np.ndarray:
    """Stack ragged waveforms into a zero-padded (B, N_max) batch.

    Trailing zeros are silent (constant signal -> no zero crossings after
    the last real sample beyond one transition; frames there can't pass
    CRC + signal gates), so padding is decode-neutral.  int16 batches are
    supported (conditioned on device, half the transfer bytes).
    """
    n_max = max(len(p) for p in pcms)
    if dtype is None:
        if all(np.issubdtype(np.asarray(p).dtype, np.integer) for p in pcms):
            # widest input integer type — int32 samples must not truncate
            dtype = np.result_type(*[np.asarray(p).dtype for p in pcms])
        else:
            dtype = np.float32
    out = np.zeros((len(pcms), n_max), dtype=dtype)
    for i, p in enumerate(pcms):
        out[i, : len(p)] = p
    return out


@functools.lru_cache(maxsize=8)
def _batched_fused(dims, fs, bitrate, bit_inset, edge_pad, mesh=None):
    """vmapped whole-decode program (stage 1 + device back half)."""
    def decode(pcm, n_valid, ptrig, sos, btrig, trig_i, trig_f, hdr_rel,
               calib_off, coeff_defaults, temp_lut, limits):
        return eng.fused_core(pcm, n_valid, ptrig, sos, btrig, trig_i,
                              trig_f, hdr_rel, calib_off, coeff_defaults,
                              temp_lut, limits, dims, fs, bitrate,
                              bit_inset, edge_pad)

    fn = jax.vmap(decode, in_axes=(0, 0) + (None,) * 10)
    if mesh is None:
        return jax.jit(fn)
    sh = NamedSharding(mesh, P("dp", None))
    sh1 = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, in_shardings=(sh, sh1) + (rep,) * 10)


@functools.lru_cache(maxsize=8)
def _batched_back_half(dims, fs):
    """vmapped device back half, for callers with their own front end
    (the time-sharded dp x sp path); input sharding follows the caller's
    arrays."""
    def back_half(r400, r7500, edges, n_edges, s1p, s2p, n_valid, ovf0,
                  trig_i, trig_f, hdr_rel, calib_off, coeff_defaults,
                  temp_lut, limits):
        c0 = s2p / jnp.maximum(s1p, 1e-30)  # see eng.stage15_core
        return eng.back_half_core(r400, r7500, edges, n_edges, c0,
                                  n_valid, trig_i, trig_f, hdr_rel,
                                  calib_off, coeff_defaults, temp_lut,
                                  limits, dims, fs, overflow0=ovf0)

    return jax.jit(jax.vmap(back_half, in_axes=(0,) * 8 + (None,) * 7))


def finish_batch(out_host, cfg: DecoderConfig, fs: float, fs_report,
                 lengths, wire_used: str | None = None) -> list[DecodeResult]:
    """Per-row host finish (status, exact metadata, report fields);
    ``out_host`` is the (B, L) packed result matrix (one int32 row per
    drop — see back_half_core)."""
    out_host = np.asarray(out_host)
    return [
        eng.finish_result(out_host[i], fs_report, int(lengths[i]), fs, cfg,
                          wire_used=wire_used)
        for i in range(out_host.shape[0])
    ]


def run_back_half_batched(s1: dict, cfg: DecoderConfig, fs: float, dims,
                          lengths, fs_report) -> list[DecodeResult]:
    """Device back half + host finish for an externally computed stage 1.

    One dispatch, one blocking device->host transfer for the whole batch;
    bits/edges/headers never leave the device."""
    bh = _batched_back_half(dims, float(fs))
    params = eng.fused_inputs(cfg, float(fs))
    ovf0 = s1.get("overflow")
    if ovf0 is None:
        ovf0 = jnp.zeros_like(s1["n_edges"])
    out = bh(s1["r400"], s1["r7500"], s1["edge_samples"], s1["n_edges"],
             s1["s1"], s1["s2"], jnp.asarray(np.asarray(lengths, np.int32)),
             ovf0, params["trig_i"], params["trig_f"], params["hdr_rel"],
             params["calib_off"], params["coeff_defaults"],
             params["temp_lut"], params["limits"])
    out_host = jax.device_get(out)
    return finish_batch(out_host, cfg, fs, fs_report, lengths)


def dispatch_batch(pcms, fs, config: DecoderConfig | None = None,
                   mesh: Mesh | None = None, dtype=jnp.float32,
                   lengths=None, wire: str = "auto"):
    """Asynchronously dispatch a (B, N) batch decode; returns (out, ctx)
    for :func:`finish_dispatched`.

    The whole batch is ONE device dispatch (vmapped fused decode, dp-
    sharded when a mesh is given); nothing blocks until the finish call
    fetches the packed result tree, so callers can overlap the next
    batch's host work (reads, reports) with this batch's device compute
    (the archive runner does exactly this)."""
    cfg = config or DecoderConfig()
    fs_report = float(fs) if isinstance(fs, float) else int(fs)
    fs = float(fs)
    pcms = np.asarray(pcms)
    if pcms.dtype == np.uint8:
        raise ValueError("pass unpacked integer rows with wire='int4'; "
                         "pre-packed nibble streams lose the sample count")
    b_orig, n = pcms.shape
    if lengths is None:
        lengths = np.full(b_orig, n, np.int32)
    lengths = np.asarray(lengths, np.int32)
    if np.issubdtype(pcms.dtype, np.integer):
        from ..ops import wire as wire_ops

        wire_used = wire_ops.resolve_wire(wire, pcms.dtype)
        pcms = wire_ops.encode_rows(pcms, wire_used)
        if pcms.dtype == np.uint8:
            n += n % 2  # packed int4 rows carry an even sample count
    else:
        wire_used = "float32"
    if mesh is not None:
        (pcms, lengths), _ = pad_to_multiple([pcms, lengths], mesh.shape["dp"])
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    dims = eng.EngineDims.for_waveform(n, fs, cfg.bitrate, npcm)
    ptrig, btrig, sos = eng.engine_tables(cfg, fs, dims)
    fused = _batched_fused(dims, fs, float(cfg.bitrate), cfg.bit_inset, 100,
                           mesh)
    x = jnp.asarray(pcms) if np.issubdtype(pcms.dtype, np.integer) \
        else jnp.asarray(pcms, dtype)
    params = eng.fused_inputs(cfg, fs, dtype)
    out = fused(x, jnp.asarray(lengths), jnp.asarray(ptrig, dtype),
                jnp.asarray(sos, dtype), jnp.asarray(btrig, dtype),
                params["trig_i"], params["trig_f"], params["hdr_rel"],
                params["calib_off"], params["coeff_defaults"],
                params["temp_lut"], params["limits"])
    return out, (cfg, fs, fs_report, lengths, b_orig, wire_used)


def finish_dispatched(out, ctx) -> list[DecodeResult]:
    """Fetch + host-finish a dispatch_batch result (the blocking step)."""
    cfg, fs, fs_report, lengths, b_orig, wire_used = ctx
    out_host = jax.device_get(out)
    return finish_batch(out_host, cfg, fs, fs_report, lengths,
                        wire_used=wire_used)[:b_orig]


def decode_batch(pcms, fs, config: DecoderConfig | None = None,
                 mesh: Mesh | None = None, dtype=jnp.float32,
                 lengths=None, wire: str = "auto",
                 lossy_retry: bool = True) -> list[DecodeResult]:
    """Decode a (B, N) batch of waveforms; returns B results.

    One device dispatch + one blocking device->host transfer.  Integer
    batches are conditioned on device; for zero-padded ragged batches
    pass `lengths` (true samples per row) so DC removal averages over
    real samples only and the trigger grid stops at real windows.
    ``wire`` selects the integer upload format (ops.wire; "auto" =
    int16).  Rows whose int4-wire decode comes back degenerate (the noise-shaped wire's content-dependent cliff —
    eng.lossy_retry_worthy) are re-decoded once at int8 in one padded
    batch dispatch (``lossy_retry=False`` measures the pure int4 path).
    """
    results = finish_dispatched(*dispatch_batch(
        pcms, fs, config=config, mesh=mesh, dtype=dtype, lengths=lengths,
        wire=wire))
    if lossy_retry:
        results = retry_lossy_rows(results, pcms, fs, config=config,
                                   mesh=mesh, dtype=dtype, lengths=lengths)
    return results


def retry_lossy_rows(results: list[DecodeResult], pcms, fs,
                     config: DecoderConfig | None = None,
                     mesh: Mesh | None = None, dtype=jnp.float32,
                     lengths=None) -> list[DecodeResult]:
    """Re-decode the degenerate int4-wire rows of ``results`` at int8.

    All flagged rows go in ONE batch dispatch, padded to the original
    batch width by repeating the first flagged row (same program shape
    as a first-class int8 decode of this batch — one cached compile,
    no per-retry-count shapes)."""
    cfg = config or DecoderConfig()
    pcms = np.asarray(pcms)
    b, n = pcms.shape
    if lengths is None:
        lengths = np.full(b, n, np.int32)
    flagged = [i for i, r in enumerate(results)
               if eng.lossy_retry_worthy(r, int(lengths[i]), float(fs), cfg)]
    if not flagged:
        return results
    pad = [flagged[0]] * (b - len(flagged))
    idx = flagged + pad
    redo = decode_batch(pcms[idx], fs, config=cfg, mesh=mesh, dtype=dtype,
                        lengths=np.asarray(lengths)[idx], wire="int8",
                        lossy_retry=False)
    out = list(results)
    for k, i in enumerate(flagged):
        out[i] = redo[k]
    return out
