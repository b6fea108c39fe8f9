"""CRC-6 frame validation for the AXCTD 32-bit frame format.

The AXCTD frame is 32 bits: 26 payload bits followed by a 6-bit CRC with
generator polynomial x^6 + x^5 + x^2 + 1 (bit vector ``1100101``,
"decimal 101"; reference parse.py:310-322 and README.md:87).  A frame is
valid iff GF(2) long division of the full 32 bits by the generator
leaves remainder zero.

Because CRC over GF(2) is linear, validity of every 32-bit window of a
bitstream can be computed at once as a matrix product: remainder(w) =
M @ w mod 2 for a fixed 6x32 parity matrix M, evaluated for all sliding
windows simultaneously — one vectorized pass instead of the
reference's 26-iteration Python loop per window.  This is the
"vectorized CRC validity" used by frame sync (ops.chain).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

GENERATOR = np.array([1, 1, 0, 0, 1, 0, 1], dtype=np.uint8)
FRAME_BITS = 32
DATA_BITS = 26
CRC_BITS = 6


def _remainder_np(bits: np.ndarray) -> np.ndarray:
    """GF(2) long-division remainder of a 32-bit word (low-level, numpy)."""
    r = np.array(bits, dtype=np.uint8, copy=True)
    for k in range(DATA_BITS):
        if r[k]:
            r[k : k + 7] ^= GENERATOR
    return r[DATA_BITS:]


def check_crc_np(frame) -> bool:
    """True iff the 32-bit frame passes CRC-6 (remainder == 0)."""
    frame = np.asarray(frame, dtype=np.uint8)
    if frame.shape != (FRAME_BITS,):
        raise ValueError(f"frame must be 32 bits, got {frame.shape}")
    return not _remainder_np(frame).any()


def encode_crc_np(payload) -> np.ndarray:
    """Append the 6 CRC bits to a 26-bit payload, producing a valid frame.

    This is the encoder inverse of the reference's checker — used by the
    synthetic AXCTD signal simulator (models.simulator).
    """
    payload = np.asarray(payload, dtype=np.uint8)
    if payload.shape != (DATA_BITS,):
        raise ValueError(f"payload must be 26 bits, got {payload.shape}")
    word = np.concatenate([payload, np.zeros(CRC_BITS, dtype=np.uint8)])
    crc = _remainder_np(word)
    return np.concatenate([payload, crc])


def parity_matrix() -> np.ndarray:
    """The 32x6 GF(2) matrix P with remainder(w) = (w @ P) mod 2.

    Row i is the CRC remainder contribution of bit i (linearity of CRC:
    remainder of a word is the XOR of remainders of its one-hot bits).
    """
    p = np.zeros((FRAME_BITS, CRC_BITS), dtype=np.uint8)
    for i in range(FRAME_BITS):
        onehot = np.zeros(FRAME_BITS, dtype=np.uint8)
        onehot[i] = 1
        p[i] = _remainder_np(onehot)
    return p


_PARITY = parity_matrix()


def check_crc_all_windows_np(bitstream: np.ndarray) -> np.ndarray:
    """CRC validity of every 32-bit sliding window of `bitstream` (numpy).

    Returns a bool array of length ``len(bitstream) - 31``.
    """
    bits = np.asarray(bitstream, dtype=np.uint8)
    n = len(bits) - FRAME_BITS + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    windows = np.lib.stride_tricks.sliding_window_view(bits, FRAME_BITS)
    rem = (windows.astype(np.int32) @ _PARITY.astype(np.int32)) & 1
    return ~rem.any(axis=1)


# parity rows packed into one int per row: bit j of _PACKED[i] is
# _PARITY[i, j].  XOR accumulates each field mod 2 with no cross-field
# carries, so the whole 6-lane remainder rides ONE int32 stream.
_PACKED = (_PARITY.astype(np.int32) << np.arange(CRC_BITS)).sum(axis=1)


# column j of the parity matrix packed as a 32-bit mask over the frame
# WORD layout word[i] = sum_k bits[i+k] << (31-k): remainder bit j of a
# window is the GF(2) dot product of its bits with parity column j =
# popcount(word & _COLMASK[j]) mod 2.
_COLMASK = [int(sum(int(_PARITY[k, j]) << (31 - k) for k in range(FRAME_BITS)))
            for j in range(CRC_BITS)]


def check_crc_words(words: jnp.ndarray) -> jnp.ndarray:
    """CRC validity from pre-built 32-bit frame words (big-endian bit
    order: word[i] carries bits i..i+31 with bit i in the MSB).

    The profile stage already builds the word at every offset for the
    hexframe field (tpu_engine.stage2_core's Horner pass), so validity
    is 6 ``population_count`` + AND ops over the SAME stream — the
    separate 32-pass shifted-XOR sweep of :func:`check_crc_all_windows`
    disappears from the program.  A zero word (zero padding past the
    stream) has remainder 0 and reads as valid: callers must mask the
    tail, exactly as they already mask ``idx < n_bits - 32``.
    """
    w = words.astype(jnp.uint32)
    bad = jnp.zeros(w.shape, jnp.uint32)
    for j in range(CRC_BITS):
        bad |= jax.lax.population_count(w & jnp.uint32(_COLMASK[j])) & 1
    return bad == 0


def check_crc_all_windows(bitstream: jnp.ndarray) -> jnp.ndarray:
    """CRC validity of every 32-bit sliding window (JAX).

    `bitstream` is an int array of 0/1 of static length N; returns a bool
    array of length N (positions past N-32 are False).  Implemented as 32
    shifted XORs of bit-packed parity rows — elementwise work on a
    single (N,) int32 stream, no gathers, no (N, 6) remainder array.
    """
    bits = bitstream.astype(jnp.int32)
    n = bits.shape[0]
    rem = jnp.zeros((n,), dtype=jnp.int32)
    for i in range(FRAME_BITS):
        # bits[s + i] selects row i's packed parity (bits are 0/1)
        rem = rem ^ (jnp.roll(bits, -i) * int(_PACKED[i]))
    idx = jnp.arange(n)
    return (rem == 0) & (idx <= n - FRAME_BITS)
