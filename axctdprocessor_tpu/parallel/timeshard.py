"""Sequence-parallel decode: one waveform's time axis sharded over devices.

For very long recordings (or many long drops at once), the compute-heavy
front end — tone-power windows, IIR filtering, zero-crossing extraction,
per-crossing tone probes — is sharded over the time axis with **halo
exchange** between devices (``lax.ppermute`` inside ``shard_map``), the
DSP analog of ring-attention block overlap (SURVEY.md 2.5):

* each block receives ``n_power`` raw samples from its right neighbor so
  its strided power windows can straddle the boundary;
* each block receives a warm-up tail of raw samples from its left
  neighbor so the IIR filter state is settled by the block start (the
  reference resets filter state per 2 s chunk, so a 2048-sample warm-up
  is strictly more faithful than its own semantics);
* each block receives a short filtered halo from the right for crossing
  detection and per-crossing mark/space probes at the boundary.

The trick that removes cross-shard sequencing: tone probes are computed
for **every zero crossing**, not just chained bit edges (~2x compute,
embarrassingly parallel).  The tiny chained part — the greedy bit-edge
walk — then runs on the gathered (crossing, p1, p2) table with pointer
doubling, after a single all-gather along the sequence axis.

Outputs match `stage1_core`'s contract, so the host interlude and stage-2
profile decode are shared with the single-device and batch paths.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models import tpu_engine as eng
from ..models.parity_engine import DecodeResult
from ..ops import chain as chain_ops
from ..ops import goertzel, iir
from ..utils.config import DecoderConfig

WARMUP = 2048  # IIR warm-up halo (filter transient < ~1k samples at 44.1k)
BIG = np.iinfo(np.int32).max // 2


def pad_for_mesh(pcms: np.ndarray, fs: float, n_sp: int) -> np.ndarray:
    """Zero-pad (B, N) so N divides evenly into n_sp blocks of whole
    power-window strides."""
    b, n = pcms.shape
    d_pcm = int(round(fs / 25))
    unit = n_sp * d_pcm
    n_pad = int(np.ceil(n / unit)) * unit
    if n_pad == n:
        return pcms
    out = np.zeros((b, n_pad), dtype=pcms.dtype)
    out[:, :n] = pcms
    return out


@functools.lru_cache(maxsize=8)
def _sharded_frontend(mesh: Mesh, dims, fs: float, bit_inset: int, edge_pad: int,
                      integer_input: bool = False):
    n_sp = mesh.shape["sp"]
    n = dims.n
    assert n % n_sp == 0, "pad with pad_for_mesh first"
    block = n // n_sp
    assert block % dims.d_pcm == 0
    cross_halo = dims.npcm + bit_inset + 1
    # crossing capacity is duration-based (Rice-rate ceiling, see
    # ops.chain.CROSSINGS_PER_SECOND), mirroring the bound
    # EngineDims.for_waveform uses for the single-device engine
    max_cross_blk = max(
        int(block / fs * chain_ops.CROSSINGS_PER_SECOND) + 256, 1024)
    fwd = [(i, (i + 1) % n_sp) for i in range(n_sp)]   # send right
    bwd = [(i, (i - 1) % n_sp) for i in range(n_sp)]   # send left

    def frontend(x_blk, n_valid, ptrig, btrig, sos_arr):
        # x_blk: (b_local, block); n_valid: (b_local,) true global lengths
        sp_i = lax.axis_index("sp")
        is_first = sp_i == 0
        is_last = sp_i == n_sp - 1
        gpos_blk = jnp.arange(block) + sp_i * block

        if integer_input:
            # condition raw integer PCM on device: the DC mean and peak
            # are global per-row statistics, reduced over the "sp" axis
            # (psum/pmax); zero padding past n_valid contributes nothing
            # to the sum or the peak, and the mean divides by the true
            # length so it stays exact
            xf = x_blk.astype(jnp.float32)
            total = lax.psum(jnp.sum(xf, axis=1), "sp")
            peak = lax.pmax(jnp.max(jnp.abs(xf), axis=1), "sp")
            mean = total / n_valid.astype(jnp.float32)
            x_blk = jnp.where(
                gpos_blk[None, :] < n_valid[:, None],
                (xf - mean[:, None]) / jnp.maximum(peak, 1.0)[:, None], 0.0)

        # --- power windows with right raw halo --------------------------
        right_raw = lax.ppermute(x_blk[:, : dims.n_power], "sp", bwd)
        right_raw = jnp.where(is_last, 0.0, right_raw)
        x_ext = jnp.concatenate([x_blk, right_raw], axis=1)

        # block + n_power samples hold exactly block / d_pcm windows
        powers = jax.vmap(lambda row: goertzel.framed_tone_power(
            row, dims.n_power, dims.d_pcm, ptrig))(x_ext)  # (b, wins, 3)

        # --- filter with left warm-up halo -------------------------------
        # Overlap-save FFT filtering with the exact SOS response, like the
        # segmented engine (segmented.py): the associative-scan IIR the
        # blocks previously used has a log-depth graph whose compile time
        # grows with block length (tpu_engine.stage1_core) — and SP
        # exists for exactly the longest files, whose per-device blocks
        # are minutes of audio.  The WARMUP
        # left halo absorbs both the filter ring-in and the circular
        # wrap-around (IIR transient < ~1k samples << WARMUP).
        left_raw = lax.ppermute(x_blk[:, -WARMUP:], "sp", fwd)
        left_raw = jnp.where(is_first, 0.0, left_raw)
        x_warm = jnp.concatenate([left_raw, x_blk], axis=1)
        nfft = iir.next_pow2(block + WARMUP)
        resp = eng.sos_response_on_device(sos_arr, nfft)
        spec = jnp.fft.rfft(x_warm, nfft, axis=1) * resp[None, :]
        filt = jnp.fft.irfft(spec, nfft, axis=1)[:, WARMUP : WARMUP + block]
        filt = filt.astype(x_warm.dtype)

        # --- crossings + per-crossing tone probes ------------------------
        right_f = lax.ppermute(filt[:, :cross_halo], "sp", bwd)
        right_f = jnp.where(is_last, 0.0, right_f)
        f_ext = jnp.concatenate([filt, right_f], axis=1)

        def cross_one(row, nv):
            sgn = jnp.where(row >= 0, 1, -1)
            is_c = sgn[:block] != sgn[1 : block + 1]
            is_c &= gpos_blk >= edge_pad
            # no bit edges in the zero-padded tail (filter ring-down there
            # would otherwise demodulate into garbage frames)
            is_c &= gpos_blk < nv - 1
            pos, cnt, rovf = chain_ops.compact_indices_rowcap(
                is_c, max_cross_blk, BIG,
                row_cap=chain_ops.rowcap_for_fs(fs))
            probes = goertzel.tone_power_at(
                row, jnp.clip(pos, 0, block - 1) + bit_inset, dims.npcm, btrig)
            gp = jnp.where(pos < BIG, pos + sp_i * block, BIG)
            # truncation flag: this block's crossings exceeded capacity
            ovf = (cnt > max_cross_blk).astype(jnp.int32) | rovf
            return gp.astype(jnp.int32), probes[:, 0], probes[:, 1], ovf

        gpos, p1, p2, ovf = jax.vmap(cross_one)(f_ext, n_valid)
        return powers, gpos, p1, p2, ovf[:, None]

    return shard_map(
        frontend, mesh=mesh,
        in_specs=(P("dp", "sp"), P("dp"), P(), P(), P()),
        out_specs=(P("dp", "sp", None), P("dp", "sp"), P("dp", "sp"),
                   P("dp", "sp"), P("dp", "sp")),
    )


def sharded_stage1(pcms, fs: float, cfg: DecoderConfig, mesh: Mesh,
                   dtype=jnp.float32, lengths=None):
    """Time+data sharded stage 1 over a ("dp", "sp") mesh.

    `pcms` is (B, N) with N divisible by n_sp * d_pcm (see pad_for_mesh).
    Integer batches ship raw (half the host->device bytes) and are
    conditioned on device with psum/pmax row statistics over "sp".
    Returns the stage1_core output dict, batched over B.
    """
    fs = float(fs)
    b, n = pcms.shape
    integer_input = bool(np.issubdtype(np.asarray(pcms).dtype, np.integer))
    if lengths is None:
        lengths = np.full(b, n, np.int32)
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    dims = eng.EngineDims.for_waveform(n, fs, cfg.bitrate, npcm)
    ptrig, btrig, sos = eng.engine_tables(cfg, fs, dims)

    frontend = _sharded_frontend(mesh, dims, fs, cfg.bit_inset, 100,
                                 integer_input)

    @functools.partial(jax.jit)
    def run(x, nv, pt, bt, so):
        powers, gpos, p1, p2, ovf_blk = frontend(x, nv, pt, bt, so)
        # compact the per-block crossing tables into global sorted order
        order = jnp.argsort(gpos, axis=1)
        gpos_s = jnp.take_along_axis(gpos, order, axis=1)
        p1_s = jnp.take_along_axis(p1, order, axis=1)
        p2_s = jnp.take_along_axis(p2, order, axis=1)
        n_cross = jnp.sum(gpos_s < BIG, axis=1)

        # smoothing + ratios on the gathered (small) power series
        sm = jax.vmap(lambda col: iir.boxsmooth_lag(col, 5), in_axes=1,
                      out_axes=1)
        powers_sm = jax.vmap(sm)(powers.reshape(b, -1, 3))
        r400 = jnp.log10(powers_sm[:, :, 0] / powers_sm[:, :, 2])
        r7500 = jnp.log10(powers_sm[:, :, 1] / powers_sm[:, :, 2])

        # greedy bit-edge chain on the replicated crossing table
        def chain_one(crossings, nc, q1, q2):
            edge_idx, n_edges = chain_ops.enumerate_bit_edges(
                crossings, nc, fs, float(cfg.bitrate), dims.max_edges)
            safe = jnp.clip(edge_idx, 0, crossings.shape[0] - 1)
            return (crossings[safe], n_edges, q1[safe], q2[safe])

        edges, n_edges, s1, s2 = jax.vmap(chain_one)(gpos_s, n_cross, p1_s, p2_s)
        return dict(r400=r400, r7500=r7500, edge_samples=edges,
                    n_edges=n_edges, s1=s1, s2=s2,
                    overflow=jnp.max(ovf_blk, axis=1))

    sh = NamedSharding(mesh, P("dp", "sp"))
    sh_b = NamedSharding(mesh, P("dp"))
    x = jnp.asarray(pcms) if integer_input else jnp.asarray(pcms, dtype)
    x = jax.device_put(x, sh)
    nv = jax.device_put(jnp.asarray(lengths, jnp.int32), sh_b)
    return run(x, nv, jnp.asarray(ptrig, dtype), jnp.asarray(btrig, dtype),
               jnp.asarray(sos, dtype)), dims


def decode_batch_timesharded(pcms, fs, config: DecoderConfig | None = None,
                             mesh: Mesh | None = None,
                             dtype=jnp.float32, lengths=None) -> list[DecodeResult]:
    """Full batched decode with the time-sharded front end.

    DP x SP mesh: drops sharded over "dp", each drop's waveform over
    "sp"; profile stage runs dp-sharded (it is tiny next to the front
    end).  Integer batches stay integer through the host->device transfer
    (half the bytes on exactly the long-file path this mode exists for)
    and are conditioned on device."""
    from .batch import run_back_half_batched

    cfg = config or DecoderConfig()
    fs_report = float(fs) if isinstance(fs, float) else int(fs)
    fs = float(fs)
    pcms = np.asarray(pcms)
    if not np.issubdtype(pcms.dtype, np.integer):
        pcms = pcms.astype(np.float32)
    if lengths is None:
        lengths = np.full(pcms.shape[0], pcms.shape[1], np.int32)
    lengths = np.asarray(lengths, np.int32)
    pcms = pad_for_mesh(pcms, fs, mesh.shape["sp"])
    b_orig = pcms.shape[0]
    if b_orig % mesh.shape["dp"]:
        from .batch import pad_to_multiple

        (pcms, lengths), _ = pad_to_multiple([pcms, lengths], mesh.shape["dp"])

    s1, dims = sharded_stage1(pcms, fs, cfg, mesh, dtype, lengths=lengths)

    results = run_back_half_batched(s1, cfg, fs, dims, lengths, fs_report)
    return results[:b_orig]
