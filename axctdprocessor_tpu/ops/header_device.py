"""Device-side header codec: trim, frame-sync, and coefficient decode.

These are JAX ports of the host header stages (models.frames /
models.metadata), built so the entire header path can eventually run
inside the fused decode program (today the engine ships two ~6 KB header
windows to the host; fusing removes the last mid-decode round trip and
makes batched decode fully device-resident).

Same contracts as the host versions:

* :func:`trim_header` — force the first 25 bits high, find the last
  run-of-8-ones before the ones-density collapse (pulse end), return the
  75-frame window (reference parse.py:157-183) — here as pure vectorized
  ops over a fixed-size buffer with a validity count;
* :func:`parse_header_frames` — frame-sync with the +1/+32 jump chain
  (pointer doubling), counter decode incl. the '11111'+3 form, and
  scatter of each frame's 16 data bits into its counter slot;
* :func:`decode_coefficients` — the sign/mantissa/exponent decimal
  decode of the 12-nibble coefficient strings, with per-coefficient
  validity (a hex digit A-F in a decimal field marks the coefficient
  invalid rather than crashing, unlike the upstream int() call).

Wired into models.tpu_engine.back_half_core: the fused decode program
runs trigger logic, bit decisions, header trim/sync/decode and the
profile stage in one device dispatch; the host reconstructs exact
float64 metadata from the returned (found, frames) arrays.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import chain as chain_ops
from . import crc as crc_ops

HEADER_FRAMES = 72
FRAME_BITS = 32


def trim_header(bits: jnp.ndarray, n_bits) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(start index of the 75-frame header window, window length).

    `bits` is a fixed-size int array with `n_bits` valid entries.  The
    caller slices/gathers with the returned start (device gathers are
    cheap); length is min(75*32, n_bits - start).
    """
    n = bits.shape[0]
    idx = jnp.arange(n)
    valid = idx < n_bits
    b = jnp.where(idx < 25, 1, jnp.where(valid, bits, 0))

    csum = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(b.astype(jnp.int32))])
    ones25 = csum[idx + 1] - csum[jnp.maximum(idx - 24, 0)]
    run8 = csum[idx + 1] - csum[jnp.maximum(idx - 7, 0)]

    stop_mask = (idx >= 400) & (ones25 <= 20) & valid
    stop = jnp.where(jnp.any(stop_mask), jnp.argmax(stop_mask), n_bits - 1)

    pulse_mask = (idx > 10) & (run8 == 8) & (idx <= stop) & valid
    # last True index: length-1 - argmax of the reversed mask
    last = jnp.where(jnp.any(pulse_mask),
                     n - 1 - jnp.argmax(pulse_mask[::-1]), 0)
    length = jnp.minimum(FRAME_BITS * 75, n_bits - last)
    return last.astype(jnp.int32), length.astype(jnp.int32)


def parse_header_frames(bits: jnp.ndarray, n_bits):
    """Frame-sync a header bit window and collect per-counter frame data.

    Returns (counter_found bool[72], frame_nibbles int32[72, 4]).
    `bits` is the fixed-size trimmed window (int 0/1), `n_bits` its valid
    length.  Scan semantics mirror the upstream loop: advance 1 on an
    invalid window, 32 on a '10'+CRC frame; frames whose counter exceeds
    71 are consumed but ignored, and — matching the upstream early stop —
    nothing after the first frame 71 writes a slot (fake CRC-colliding
    frames in the trailing pad of the trimmed window would otherwise
    overwrite real data).
    """
    n = bits.shape[0]
    idx = jnp.arange(n)
    in_range = idx < n_bits
    crc_ok = crc_ops.check_crc_all_windows(bits)
    sync = (bits == 1) & (jnp.roll(bits, -1) == 0)
    accept = sync & crc_ok & in_range & (idx < n_bits - FRAME_BITS)

    max_steps = n
    max_frames = n // FRAME_BITS + 2
    starts, n_frames, _, _ = chain_ops.enumerate_frames(
        accept, n_bits, max_steps=max_steps, max_frames=max_frames)

    fwin = bits[starts[:, None] + jnp.arange(FRAME_BITS)]
    frame_ok = jnp.arange(max_frames) < n_frames

    counter_bits = fwin[:, 2:10]
    w8 = jnp.asarray(1 << np.arange(7, -1, -1), jnp.int32)
    plain = jnp.sum(counter_bits * w8, axis=1)
    high = jnp.sum(counter_bits[:, :5], axis=1) == 5
    w3 = jnp.asarray([4, 2, 1], jnp.int32)
    counter = jnp.where(high, jnp.sum(counter_bits[:, 5:] * w3, axis=1) + 64,
                        plain)
    counter_ok = frame_ok & (counter <= 71)
    # the upstream loop stops once counter 71 is seen — garbage in the
    # trailing 3-frame pad of the trimmed window must not overwrite slots
    saw71 = counter_ok & (counter == 71)
    k71 = jnp.where(jnp.any(saw71), jnp.argmax(saw71), max_frames)
    counter_ok &= jnp.arange(max_frames) <= k71

    nib = fwin[:, 10:26].reshape(-1, 4, 4) @ jnp.asarray([8, 4, 2, 1], jnp.int32)
    slot = jnp.where(counter_ok, counter, HEADER_FRAMES)
    # later frames with a repeated counter win (the upstream dict
    # assignment is last-wins).  A scatter-set with duplicate indices
    # applies them in no fixed order on the GPU, so each slot takes the
    # max frame index (order-free) and gathers that frame's nibbles.
    winner = jnp.full((HEADER_FRAMES + 1,), -1, jnp.int32).at[slot].max(
        jnp.arange(max_frames, dtype=jnp.int32))[:HEADER_FRAMES]
    found = winner >= 0
    frames = jnp.where(found[:, None], nib[jnp.maximum(winner, 0)], 0)
    return found, frames


# coefficient layout: coefficient i of z/t/c spans these base frames +2
COEFF_BASES = {
    "z": (21, 18, 15, 12),
    "t": (33, 30, 27, 24),
    "c": (45, 42, 39, 36),
}

WINDOW_BITS = FRAME_BITS * 75  # trimmed header window capacity


def parse_header_window(win_bits: jnp.ndarray, n_bits):
    """One header capture window -> (found bool[72], frames i32[72,4],
    usable bool).

    Chains trim -> gather of the 75-frame window -> frame sync, entirely
    on device.  ``usable`` mirrors the host gates: a window shorter than
    72 frames before or after trimming never yields a header (the host
    path skips parse_header entirely and reports the header as absent
    rather than empty).
    """
    start, length = trim_header(win_bits, n_bits)
    idx = jnp.arange(WINDOW_BITS)
    trimmed = win_bits[jnp.clip(start + idx, 0, win_bits.shape[0] - 1)]
    trimmed = jnp.where(idx < length, trimmed, 0)
    found, frames = parse_header_frames(trimmed, length)
    usable = (n_bits >= HEADER_FRAMES * FRAME_BITS) & \
        (length >= HEADER_FRAMES * FRAME_BITS)
    return found & usable, frames, usable


def merge_live_coeffs(vals2, ok2, vals3, ok3, defaults):
    """Device port of the header merge + live-coefficient adoption.

    ``vals*/ok*`` are decode_coefficients outputs (rows z, t, c) with any
    crashed header's ``ok`` rows already zeroed; ``defaults`` is f32[3,4]
    (config defaults, same row order).  Semantics mirror
    models.metadata.merge_headers: per-slot fill-in with header 3
    winning, adoption of a full 4/4-valid set, and the upstream quirk
    that **zcoeff adoption is gated on tcoeff validity** — including the
    initializer leak: the adopted zcoeff row is the *metadata* row, whose
    never-decoded slots hold the metadata initializer 1.0, not the
    config default (reference AXCTDprocessor.py:534-535, parse.py:190).
    """
    ok = ok2 | ok3
    merged = jnp.where(ok3, vals3, jnp.where(ok2, vals2, 0.0))
    t_all = jnp.all(ok[1])
    c_all = jnp.all(ok[2])
    z_meta = jnp.where(ok[0], merged[0], 1.0)  # metadata zcoeff init is 1s
    live_z = jnp.where(t_all, z_meta, defaults[0])
    live_t = jnp.where(t_all, merged[1], defaults[1])
    live_c = jnp.where(c_all, merged[2], defaults[2])
    return live_z, live_t, live_c


def decode_coefficients(found: jnp.ndarray, frames: jnp.ndarray):
    """All twelve conversion coefficients from header frame data.

    Returns ``(values f32[3,4], valid bool[3,4], mant i32[3,4],
    exp i32[3,4], crash bool)`` ordered z, t, c.

    Decode contract = the upstream expression
    ``int(chex[:9].replace(B,+).replace(D,-)) / 1e7 * 10**int(chex[9:])``
    (reference parse.py:277-279): position 0 / 9 may be a sign nibble
    (0xB='+', 0xD='-') **or a plain decimal digit** (9-digit mantissa /
    3-digit exponent); every other nibble must be decimal.  Any other
    nibble makes ``int()`` raise upstream — ``crash`` is True when any
    coefficient with all three frames found is unparseable, so callers
    can discard the whole header exactly like the host path's
    try/except ValueError.  ``mant``/``exp`` are the exact signed
    integers, letting the host reconstruct the float64 value
    bit-identically; ``values`` is the float32 on-device version used by
    the fused conversion stage.
    """
    values, valids, mants, exps = [], [], [], []
    crash = jnp.asarray(False)
    for name in ("z", "t", "c"):
        for base in COEFF_BASES[name]:
            have = found[base] & found[base + 1] & found[base + 2]
            nib = jnp.concatenate([frames[base], frames[base + 1],
                                   frames[base + 2]])  # (12,) nibbles
            m_sign_nib = jnp.isin(nib[0], jnp.asarray([0xB, 0xD]))
            e_sign_nib = jnp.isin(nib[9], jnp.asarray([0xB, 0xD]))
            m_ok = (m_sign_nib | (nib[0] <= 9)) & jnp.all(nib[1:9] <= 9)
            e_ok = (e_sign_nib | (nib[9] <= 9)) & jnp.all(nib[10:] <= 9)

            w8 = jnp.asarray(10 ** np.arange(7, -1, -1), jnp.int32)
            d8 = jnp.sum(jnp.minimum(nib[1:9], 9) * w8)
            msign = jnp.where(nib[0] == 0xD, -1, 1)
            mant = jnp.where(m_sign_nib, msign * d8,
                             jnp.minimum(nib[0], 9) * jnp.int32(10 ** 8) + d8)
            d2 = jnp.minimum(nib[10], 9) * 10 + jnp.minimum(nib[11], 9)
            esign = jnp.where(nib[9] == 0xD, -1, 1)
            exp = jnp.where(e_sign_nib, esign * d2,
                            jnp.minimum(nib[9], 9) * 100 + d2)

            value = (mant.astype(jnp.float32) / jnp.float32(1e7)
                     * 10.0 ** jnp.clip(exp, -40, 40).astype(jnp.float32))
            values.append(value)
            valids.append(have & m_ok & e_ok)
            mants.append(mant)
            exps.append(exp)
            crash |= have & ~(m_ok & e_ok)
    return (jnp.stack(values).reshape(3, 4),
            jnp.stack(valids).reshape(3, 4),
            jnp.stack(mants).reshape(3, 4),
            jnp.stack(exps).reshape(3, 4),
            crash)
