"""Two-stage cross-device pipeline for archive decoding.

SURVEY.md 2.5's optional pipeline axis: the DSP front end (stage 1 —
most of the device compute: FFT filtering, tone powers, crossing probes)
runs on one device while the decode back half (trigger + bit decisions +
headers + profile) for the *previous* batch runs on another.  Batch k's
front end overlaps batch k-1's back half and the host finish, so the
front-end device is never idle between batches — the decode analog of
pipeline parallelism, with the inter-stage activation transfer an async
device-to-device copy of the stage-1 output tables.

For this workload DP over drops is usually the better use of extra
devices (drops are independent); the pipeline is for the case where a
single batch's front end already saturates one device and latency per
batch matters.  All dispatches are async: the host only blocks on each
batch's final result fetch.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..models import tpu_engine as eng
from ..models.parity_engine import DecodeResult
from ..utils.config import DecoderConfig
from .batch import _batched_back_half, finish_batch


@functools.lru_cache(maxsize=8)
def _batched_stage1(dims, fs, bitrate, bit_inset, edge_pad):
    def stage1(pcm, n_valid, ptrig, sos, btrig):
        return eng.stage1_core(pcm, ptrig, sos, btrig, dims, fs, bitrate,
                               bit_inset, edge_pad, n_valid=n_valid)

    return jax.jit(jax.vmap(stage1, in_axes=(0, 0, None, None, None)))


def decode_batches_pipelined(batches, fs, config: DecoderConfig | None = None,
                             devices=None,
                             wire: str = "auto",
                             lossy_retry: bool = True) -> list[list[DecodeResult]]:
    """Decode an iterable of (pcms, lengths) batches through a two-device
    front-end/back-half pipeline.  Every batch must share (fs, shape).
    Integer batches honor the ``wire`` upload format (ops.wire); rows
    whose int4-wire decode comes back degenerate are re-decoded once at
    int8 (see batch.decode_batch).

    Returns one list of DecodeResults per input batch, in order.
    """
    cfg = config or DecoderConfig()
    fs_report = float(fs) if isinstance(fs, float) else int(fs)
    fs = float(fs)
    devs = devices if devices is not None else jax.devices()
    d_front = devs[0]
    d_back = devs[1] if len(devs) > 1 else devs[0]

    batches = list(batches)
    if not batches:
        return []
    from ..ops import wire as wire_ops

    first = np.asarray(batches[0][0])
    if first.dtype == np.uint8:
        raise ValueError("pass unpacked integer rows with wire='int4'; "
                         "pre-packed nibble streams lose the sample count")
    n = int(first.shape[1])
    wire_used = (wire_ops.resolve_wire(wire, first.dtype)
                 if np.issubdtype(first.dtype, np.integer) else "float32")
    if wire_used == "int4":
        n += n % 2  # packed int4 rows carry an even sample count
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    dims = eng.EngineDims.for_waveform(n, fs, cfg.bitrate, npcm)
    ptrig, btrig, sos = eng.engine_tables(cfg, fs, dims)
    stage1 = _batched_stage1(dims, fs, float(cfg.bitrate), cfg.bit_inset,
                             100)
    back = _batched_back_half(dims, fs)
    params = eng.fused_inputs(cfg, fs)

    front_consts = [jax.device_put(np.asarray(a, np.float32), d_front)
                    for a in (ptrig, sos, btrig)]
    back_consts = {k: jax.device_put(v, d_back) for k, v in params.items()}

    results: list[list[DecodeResult]] = []
    inflight = []  # (back-half out tree on d_back, lengths)

    def drain(item):
        out, lengths = item
        results.append(finish_batch(jax.device_get(out), cfg, fs, fs_report,
                                    lengths, wire_used=wire_used))

    # batch k+1's quantization + host->device upload runs in a background
    # thread while batch k dispatches and k-1 fetches: device_put of a
    # full (B, N) row block otherwise blocks the Python loop while the
    # wire drains (the serialized upload was the pipeline's real
    # bottleneck — batch throughput barely amortized over single-file)
    from concurrent.futures import ThreadPoolExecutor

    def stage(item):
        pcms, lengths = item
        pcms = np.asarray(pcms)
        lengths = np.asarray(lengths if lengths is not None
                             else [pcms.shape[1]] * pcms.shape[0], np.int32)
        if np.issubdtype(pcms.dtype, np.integer):
            pcms = wire_ops.encode_rows(pcms, wire)  # C quantizer, no GIL
        x = jax.device_put(pcms if np.issubdtype(pcms.dtype, np.integer)
                           else pcms.astype(np.float32), d_front)
        nv = jax.device_put(lengths, d_front)
        return x, nv, lengths

    stager = ThreadPoolExecutor(max_workers=1)
    staged = stager.submit(stage, batches[0])
    for bi in range(len(batches)):
        x, nv, lengths = staged.result()
        staged = (stager.submit(stage, batches[bi + 1])
                  if bi + 1 < len(batches) else None)
        s1 = stage1(x, nv, *front_consts)  # async on the front device

        # ship stage-1 tables to the back device (async inter-device copy)
        s1_b = jax.device_put(s1, d_back)
        nv_b = jax.device_put(lengths, d_back)
        out = back(s1_b["r400"], s1_b["r7500"], s1_b["edge_samples"],
                   s1_b["n_edges"], s1_b["s1"], s1_b["s2"], nv_b,
                   s1_b["overflow"],
                   back_consts["trig_i"], back_consts["trig_f"],
                   back_consts["hdr_rel"], back_consts["calib_off"],
                   back_consts["coeff_defaults"], back_consts["temp_lut"],
                   back_consts["limits"])
        inflight.append((out, lengths))
        # keep one batch in flight: fetch k-1 while k computes
        if len(inflight) > 1:
            drain(inflight.pop(0))
    while inflight:
        drain(inflight.pop(0))
    stager.shutdown(wait=False)

    if lossy_retry:
        # degenerate int4-wire rows (the noise-shaped wire's content-
        # dependent cliff — eng.lossy_retry_worthy) re-decode once at
        # int8, grouped into full-width batch dispatches (same program
        # shape as a first-class int8 batch decode: one cached compile)
        from .batch import decode_batch

        flagged = [(bi, ri)
                   for bi, batch_res in enumerate(results)
                   for ri, r in enumerate(batch_res)
                   if eng.lossy_retry_worthy(
                       r, int(np.asarray(batches[bi][1])[ri])
                       if batches[bi][1] is not None
                       else np.asarray(batches[bi][0]).shape[1],
                       fs, cfg)]
        b_width = np.asarray(batches[0][0]).shape[0]
        for g in range(0, len(flagged), b_width):
            grp = flagged[g : g + b_width]
            idx = grp + [grp[0]] * (b_width - len(grp))
            rows = np.stack([np.asarray(batches[bi][0])[ri]
                             for bi, ri in idx])
            lens = [int(np.asarray(batches[bi][1])[ri])
                    if batches[bi][1] is not None
                    else np.asarray(batches[bi][0]).shape[1]
                    for bi, ri in idx]
            redo = decode_batch(rows, fs_report, config=cfg,
                                lengths=lens, wire="int8",
                                lossy_retry=False)
            for k, (bi, ri) in enumerate(grp):
                results[bi][ri] = redo[k]
    return results
