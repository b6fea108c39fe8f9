"""Pointer-doubling chain enumeration — parallelizing the sequential loops.

Two stages of the decode are inherently sequential in the reference:

* the greedy bit-edge chain over zero crossings (demodulate.py:85-93):
  from the current crossing, hop to whichever of the next four crossings
  is nearest to one bit period ahead;
* profile/header frame sync (parse.py:57-89): advance 1 bit on a reject,
  32 bits on an accepted frame.

Both are successor functions ``next(i)`` whose value is computable for
ALL positions in parallel (the candidates/validities don't depend on the
path taken).  The chain from a start node is then enumerated with path
doubling: knowing ``chain[0:2^p]`` and the 2^p-step jump table
``J_p = next^(2^p)``, the next block is one vectorized gather
``chain[2^p : 2^{p+1}] = J_p[chain[0 : 2^p]]``, and ``J_{p+1} = J_p[J_p]``.
O(log N) gathers of O(N) instead of an O(N) sequential scan — the core
trick that makes whole-waveform decode latency-viable on an
accelerator.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

# Zero-crossing capacity per second of audio.  The demod filter is a
# 6th-order Butterworth ending at ~1300 Hz, so by Rice's formula the
# crossing rate of anything it passes is ~2*f_rms: ~1450/s for pure
# broadband noise (f_rms ~= 0.6*f_c for the order-6 response), <=1600/s
# for the FSK signal itself (800 baud, 400/800 Hz tones).  3000/s is a
# >=2x ceiling over any decodable content; it directly scales the
# pointer-doubling jump table, whose full-table squaring gathers are the
# chain's dominant cost.  Inputs that exceed it (possible only for
# band-edge interference with no in-band signal, i.e. nothing decodable)
# truncate: crossings past capacity are dropped.
CROSSINGS_PER_SECOND = 3000


def compact_indices(mask: jnp.ndarray, size: int, fill: int):
    """Indices of True entries, compacted into a fixed-size buffer.

    Equivalent to ``jnp.where(mask, size=size, fill_value=fill)`` but
    lowered as cumsum + scatter (3 ops) instead of the stock
    bounded-nonzero lowering.  Returns (indices int32[size], true_count
    — may exceed `size`, the caller's overflow signal).

    A scatter-free two-level form (``compact_indices_blocked``: 128-lane
    barrel-shift block compaction + offset stitch) is kept below for
    A/B comparison: it lost to the 3-op scatter on the accelerator the
    decode was first built for, and is not yet measured on the GPU.
    """
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = jnp.where(mask, jnp.minimum(pos, size), size)
    out = jnp.full((size + 1,), fill, jnp.int32).at[slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    return out[:size], pos[-1] + 1


def _block_compact_rows(m: jnp.ndarray):
    """Stable within-row compaction of a (n_blk, B) boolean mask's set
    LANE indices to the row front, via an LSB-first barrel shift.

    Each set lane must move left by ``dist = lane - rank`` (the count of
    unset lanes before it), which is non-decreasing along the row — the
    classic SIMD stream-compaction invariant that makes the log2(B)
    power-of-two shift rounds collision-free.  All operations are
    element-wise + lane rolls (sequential memory traffic only).

    Returns (lanes int32 (n_blk, B) — set-lane indices packed at the row
    front, garbage beyond the row count; counts int32 (n_blk,)).
    """
    n_blk, b_sz = m.shape
    v = m > 0
    lane = jnp.arange(b_sz, dtype=jnp.int32)[None, :]
    pos = jnp.cumsum(m.astype(jnp.int32), axis=1) - 1   # rank within row
    counts = pos[:, -1] + 1
    dist = jnp.where(v, lane - pos, 0)                  # left-shift amount
    val = jnp.broadcast_to(lane, m.shape)
    step = 1
    while step < b_sz:
        move = v & ((dist & step) > 0)
        # incoming occupant from lane+step (no row wrap-around)
        can_recv = lane < b_sz - step
        val_in = jnp.roll(val, -step, axis=1)
        dist_in = jnp.roll(dist, -step, axis=1)
        move_in = jnp.roll(move, -step, axis=1) & can_recv
        stay = v & ~move
        val = jnp.where(move_in, val_in, val)
        dist = jnp.where(move_in, dist_in - step, dist)
        v = move_in | stay
        step *= 2
    return val, counts


def compact_indices_blocked(mask: jnp.ndarray, size: int, fill: int):
    """Scatter-free compaction (negative result — see compact_indices).

    Two levels: 128-lane blocks compact locally with a barrel shift
    (element-wise + lane rolls — sequential memory traffic), then the
    global result is stitched from per-block offsets with one
    size-bounded gather.  Kept only for A/B in microbench_chain.py.
    """
    n = mask.shape[0]
    B = 128
    n_blk = -(-n // B)
    m = mask
    if n_blk * B != n:
        m = jnp.concatenate(
            [m, jnp.zeros((n_blk * B - n,), dtype=m.dtype)])
    m = m.reshape(n_blk, B)
    lanes, counts = _block_compact_rows(m)
    coff = jnp.cumsum(counts) - counts              # exclusive offsets
    total = coff[-1] + counts[-1]
    base = jnp.arange(n_blk, dtype=jnp.int32) * B   # block -> global

    # block map for each output slot j WITHOUT a searchsorted (its
    # binary-search gathers cost more than the compaction): scatter one
    # mark per block start into a size-length array and prefix-sum —
    # b(j) = (#blocks with coff <= j) - 1, sequential traffic only
    marks = jnp.zeros((size + 1,), jnp.int32).at[
        jnp.minimum(coff, size)].add(1, mode="drop")
    b = jnp.cumsum(marks[:size]) - 1
    b = jnp.clip(b, 0, n_blk - 1)
    j = jnp.arange(size, dtype=jnp.int32)
    r = jnp.clip(j - coff[b], 0, B - 1)
    vals = lanes.reshape(-1)[b * B + r] + base[b]
    out = jnp.where(j < jnp.minimum(total, size), vals, fill)
    return out, total


def rowcap_for_fs(fs: float) -> int:
    """Per-128-lane-row survivor cap for crossing compaction at `fs`.

    The demod filter passes <= ~1300 Hz, so crossings are >= fs/2600
    samples apart — at 44.1 kHz that is <= ~8 per 128-lane row (cap 16
    with margin), but at 11.025 kHz the spacing shrinks to ~4 samples
    and a fixed cap of 16 would silently drop real crossings.  The +8
    margin absorbs edge effects; capped at the row size itself."""
    spacing = float(fs) / 2600.0
    return int(min(128, max(16, int(128.0 / max(spacing, 1.0)) + 8)))


def compact_indices_rowcap(mask: jnp.ndarray, size: int, fill: int,
                           row_cap: int = 16):
    """Crossing-mask compaction with a per-128-lane-row survivor cap.

    The cumsum+scatter form (compact_indices) pays scatter cost on
    every SOURCE element.  For zero-crossing masks the survivors are provably
    sparse per row: the demod filter passes <= ~1300 Hz, so crossings
    are >= ~fs/2600 ~= 17 samples apart at 44.1 kHz — at most 9 per
    128-lane row.  A per-row ``top_k`` (one fused XLA op) extracts each
    row's ascending survivor lanes into (n_rows, row_cap), and the
    global stitch scatters only ``n/128 * row_cap`` elements — 8x
    fewer.  NOT safe for masks without a spacing guarantee (e.g. frame
    accept masks, where adjacent bits can both accept).

    Returns (indices int32[size], true_count, row_overflow) —
    ``true_count`` is the exact number of True entries (may exceed
    `size`); ``row_overflow`` flags a row that exceeded ``row_cap``
    (its extra entries were dropped even if total <= size, which the
    plain form would have kept).
    """
    n = mask.shape[0]
    B = 128
    n_blk = -(-n // B)
    m = mask
    if n_blk * B != n:
        m = jnp.concatenate(
            [m, jnp.zeros((n_blk * B - n,), dtype=m.dtype)])
    m = m.reshape(n_blk, B).astype(jnp.int32)
    lane = lax.broadcasted_iota(jnp.int32, (n_blk, B), 1)
    # top_k of -lane over set lanes = ascending set-lane indices
    neg, _ = lax.top_k(jnp.where(m > 0, -lane, -(2 ** 30)), row_cap)
    lanes = -neg                               # (n_blk, row_cap)
    cnt = jnp.sum(m, axis=1)
    total = jnp.sum(cnt)
    row_ovf = (jnp.max(cnt) > row_cap).astype(jnp.int32)
    cntc = jnp.minimum(cnt, row_cap)
    coff = jnp.cumsum(cntc) - cntc
    j = lax.broadcasted_iota(jnp.int32, (n_blk, row_cap), 1)
    valid = j < cntc[:, None]
    slot = jnp.where(valid, coff[:, None] + j, size)
    base = (lax.broadcasted_iota(jnp.int32, (n_blk, 1), 0) * B)
    gl = (lanes + base).astype(jnp.int32)
    out = jnp.full((size + 1,), fill, jnp.int32).at[
        slot.reshape(-1)].set(gl.reshape(-1), mode="drop")
    return out[:size], total, row_ovf


def chain_enumerate(next_idx: jnp.ndarray, start, length: int,
                    max_level: int = 6) -> jnp.ndarray:
    """Iterate ``chain[j+1] = next_idx[chain[j]]`` for `length` steps.

    `next_idx` must map fixed points to themselves at chain ends; the
    returned array then repeats the terminal value after termination.

    The jump table is squared only up to ``span = 2^max_level`` steps:
    each squaring is a random gather over the FULL table (the dominant
    cost), while extending the chain with an existing table costs only
    the chain's own length.  The tail is filled by a `lax.scan` over
    span-sized chunks (``chunk_{t+1} = jumps[chunk_t]``), so the
    extension count never bloats the HLO graph and the per-chunk cost
    is span gathers plus loop overhead.
    """
    k = int(length)
    jumps = next_idx.astype(jnp.int32)
    # phase 1: doubling — fills chain[:first] (first = pow2 <= 2^max_level)
    # and leaves jumps == next^first when a tail remains
    first = min(1 << (k - 1).bit_length(), 1 << max_level)
    span = 1
    chain0 = jnp.zeros((first,), jnp.int32).at[0].set(start)
    while span < first:
        seg = jumps[chain0[:span]]
        chain0 = lax.dynamic_update_slice(chain0, seg, (span,))
        if 2 * span < k:  # skip the squaring no later step will use
            jumps = jumps[jumps]
        span *= 2
    if first >= k:
        return chain0[:k]
    # phase 2: scan span-sized chunks: chunk_{t+1} = next^first(chunk_t).
    # UNROLLED jump applications per scan step: the tail is latency-bound
    # on tiny dependent gathers, and 8 per iteration amortizes the loop
    # bookkeeping (same lesson as chain_enumerate_strided's tail)
    unroll = 8
    n_chunks = -(-(k - first) // (first * unroll))

    def body(chunk, _):
        outs = []
        nc = chunk
        for _ in range(unroll):
            nc = jumps[nc]
            outs.append(nc)
        return nc, jnp.stack(outs)

    _, rest = lax.scan(body, chain0, None, length=n_chunks)
    return jnp.concatenate([chain0, rest.reshape(-1)])[:k]


def chain_enumerate_strided(next_idx: jnp.ndarray, start, length: int,
                            stride_bound: int = 4,
                            max_level: int = 7) -> jnp.ndarray:
    """`chain_enumerate` for successor maps with a bounded stride:
    ``next_idx[i] - i`` in {0} ∪ [1, stride_bound] (0 marks fixed
    points).  The bit-edge chain is exactly this shape — each hop picks
    one of the next four crossings (demodulate.py:85-93 semantics).

    The jump-table squarings become **gather-free**: with
    ``delta_L[i] = next^L[i] - i``, composition is

        delta_2L[i] = delta_L[i] + delta_L[i + delta_L[i]]

    and a non-stalled L-step walk advances between L and stride_bound*L
    positions, so ``delta_L[i + delta_L[i]]`` is a select over the
    3L+1 *shifted* copies ``delta_L[i + s]``, s in [L, stride_bound*L] —
    sequential memory reads the compiler fuses, instead of the
    full-table random gathers that dominate `chain_enumerate`.  Stalled walks
    (delta < L: the chain hit a fixed point within L steps) fall outside
    the candidate set and keep delta unchanged — which is exact, because
    a stalled walk stays at its fixed point.

    The byproduct tables delta_1, delta_2, ... delta_{2^max_level} also
    replace phase-1's doubling gathers with small chain-sized ones.
    """
    k = int(length)
    n = next_idx.shape[0]
    assert stride_bound << max_level <= 32767, "delta exceeds int16"
    idx = jnp.arange(n, dtype=jnp.int32)
    # deltas stay <= stride_bound * 2^max_level << 32767: int16 halves the
    # memory traffic of the shifted-select compositions
    delta = (next_idx.astype(jnp.int32) - idx).astype(jnp.int16)
    first = min(1 << (k - 1).bit_length(), 1 << max_level)

    deltas = [delta]
    span, hi = 1, stride_bound
    while 2 * span <= first and 2 * span < k:
        acc = jnp.zeros_like(delta)
        for s in range(span, hi + 1):
            if s < n:
                shifted = jnp.concatenate(
                    [delta[s:], jnp.zeros((s,), jnp.int16)])
            else:  # shift past the table: everything lands on the pad
                shifted = jnp.zeros((n,), jnp.int16)
            acc = jnp.where(delta == jnp.int16(s), shifted, acc)
        delta = delta + acc
        deltas.append(delta)
        span *= 2
        hi *= 2

    # phase 1: doubling on the chain array (gathers of at most first/2)
    chain0 = jnp.zeros((first,), jnp.int32).at[0].set(start)
    s2 = 1
    for d in deltas:
        if s2 >= first:
            break
        seg = chain0[:s2] + d[chain0[:s2]].astype(jnp.int32)
        chain0 = lax.dynamic_update_slice(chain0, seg, (s2,))
        s2 *= 2
    if first >= k:
        return chain0[:k]

    # phase 2: scan with the final delta table.  UNROLL jump applications
    # per scan step amortize the per-iteration loop overhead, which
    # dominated the un-unrolled tail
    d_last = deltas[-1]
    unroll = 8
    n_chunks = -(-(k - first) // (first * unroll))

    def body(chunk, _):
        outs = []
        nc = chunk
        for _ in range(unroll):
            nc = nc + d_last[nc].astype(jnp.int32)
            outs.append(nc)
        return nc, jnp.stack(outs)

    _, rest = lax.scan(body, chain0, None, length=n_chunks)
    return jnp.concatenate([chain0, rest.reshape(-1)])[:k]


def bit_edge_successors(crossings: jnp.ndarray, n_valid, fs: float,
                        bitrate: float) -> jnp.ndarray:
    """Successor table for the greedy 4-candidate bit-edge chain.

    `crossings` is a padded (static-size M) ascending array of crossing
    sample indices with a large filler after position `n_valid`.  The
    successor of i is i + 1 + argmin over the next four crossings of
    their distance to crossings[i] + fs/bitrate; positions with fewer
    than 5 crossings remaining (the reference's loop bound) are fixed
    points.
    """
    m = crossings.shape[0]
    big = jnp.asarray(np.iinfo(np.int32).max // 2, dtype=crossings.dtype)
    padded = jnp.concatenate([crossings, jnp.full((5,), big, crossings.dtype)])
    # distances computed on small integer gaps first — comparing absolute
    # sample positions in f32 would quantize by ~2 samples on long files.
    # The 4 candidates are folded pairwise as (M,) streams rather than
    # an (M, 4) stack with a 4-wide minor dimension
    target = jnp.asarray(fs / bitrate, jnp.float32)
    pick = jnp.zeros((m,), jnp.int32)
    best = jnp.abs((padded[1 : 1 + m] - crossings).astype(jnp.float32)
                   - target)
    for s in range(2, 5):
        d = jnp.abs((padded[s : s + m] - crossings).astype(jnp.float32)
                    - target)
        better = d < best  # strict: argmin ties keep the earlier candidate
        pick = jnp.where(better, s - 1, pick)
        best = jnp.where(better, d, best)
    idx = jnp.arange(m, dtype=jnp.int32)
    nxt = idx + 1 + pick
    nxt = jnp.where(idx < n_valid - 5, nxt, idx)  # chain stops at c >= m-5
    return jnp.clip(nxt, 0, m - 1)


def enumerate_bit_edges(crossings: jnp.ndarray, n_valid, fs: float,
                        bitrate: float, max_edges: int):
    """Chained bit edges (values from `crossings`) + count of valid edges.

    Returns (edge_positions[max_edges] as crossing-array indices,
    n_edges).  Entry j beyond n_edges repeats the terminal index.
    """
    nxt = bit_edge_successors(crossings, n_valid, fs, bitrate)
    # the successor stride is bounded (i+1 .. i+4), so the jump-table
    # squarings run gather-free (chain_enumerate_strided) instead of
    # the full-gather chain_enumerate
    chain = chain_enumerate_strided(nxt, jnp.asarray(0, jnp.int32),
                                    max_edges)
    # valid while strictly advancing
    advanced = jnp.concatenate(
        [jnp.ones((1,), bool), chain[1:] > chain[:-1]]
    )
    n_edges = jnp.sum(jnp.cumprod(advanced.astype(jnp.int32)))
    return chain, n_edges


def enumerate_frames(accept: jnp.ndarray, n_bits, max_steps: int,
                     max_frames: int, max_level: int = 6):
    """Run frame sync over the whole bitstream at once.

    Returns (frame_starts[max_frames], n_frames, consumed, overflow)
    where `consumed` is the scan's final position (bits to drop from a
    streaming buffer) and `overflow` is an int32 truncation indicator
    (bit 0: accepted offsets exceeded the compaction capacity; bit 1:
    the frame table filled — a clipped decode is distinguishable from a
    clean one).  `accept` is the precomputed per-offset frame validity
    ('10' prefix + CRC + signal gate).

    Upstream semantics (parse.py:57-89): advance 1 bit on a reject, 32
    on an accepted frame, stop at ``n_bits - 32``.  Because every
    between-frame position is a reject, the walk reduces exactly to
    "next accepted offset at or after s + 32" — so the chain runs in the
    *accept-compacted* domain: compact the accepted offsets (ascending),
    link them with one vectorized ``searchsorted``, and pointer-double a
    ~n/16 table for max_frames steps instead of an n-sized table for
    max_steps steps.  Accept capacity n/16 + 1k is 16x the worst real
    accept density (frames every 32 bits + 1/256 spurious CRC passes);
    '10'-prefix accepts can never be adjacent, so even adversarial
    streams stay under the n/2 hard ceiling only 8x above it.

    ``max_steps`` is retained for API compatibility; the accept-domain
    walk no longer needs it.
    """
    del max_steps
    n = accept.shape[0]
    cap = min(n, n // 16 + 1024)
    big = np.iinfo(np.int32).max // 2
    idx = jnp.arange(n, dtype=jnp.int32)
    accept = accept & (idx < n_bits - 32)
    apos, n_acc = compact_indices(accept, cap, big)  # ascending, big-filled

    # successor in accept-index space: first accept at >= apos[j] + 32.
    # n_acc can exceed cap when accepts overflow the capacity (CRC-
    # colliding garbage): bound the guard by cap too or searchsorted's
    # out-of-range `cap` would survive and clamp to a wrong accept
    n_keep = jnp.minimum(n_acc, cap)
    succ = jnp.searchsorted(apos, apos + 32).astype(jnp.int32)
    j = jnp.arange(cap, dtype=jnp.int32)
    succ = jnp.where((j < n_keep) & (succ < n_keep), succ, j)

    chain = chain_enumerate(succ, jnp.asarray(0, jnp.int32), max_frames,
                            max_level=max_level)
    advancing = jnp.concatenate([(n_acc > 0)[None], chain[1:] > chain[:-1]])
    is_frame = jnp.cumprod(advancing.astype(jnp.int32)).astype(bool)
    n_frames = jnp.sum(is_frame.astype(jnp.int32))
    starts = jnp.where(is_frame, apos[jnp.clip(chain, 0, cap - 1)], 0)

    # final scan position: past the last frame the walk rejects +1 up to
    # the n_bits - 32 stop (or stops at last_start + 32 if that is past
    # it); with no frames it walks straight to the stop
    floor_pos = jnp.maximum(n_bits - 32, 0)
    last_start = jnp.max(jnp.where(is_frame, starts, -1))
    last_end = jnp.where(n_frames > 0, last_start + 32, 0)
    consumed = jnp.minimum(jnp.maximum(floor_pos, last_end), n - 1)
    overflow = ((n_acc > cap).astype(jnp.int32)
                | ((n_frames >= max_frames).astype(jnp.int32) << 1))
    return starts, n_frames, consumed, overflow
