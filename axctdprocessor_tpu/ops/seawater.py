"""Practical Salinity from conductivity (PSS-78), in JAX.

The reference pipeline computes salinity with ``gsw.SP_from_C(C, T, z)``
(reference parse.py:132, gsw 3.3.1).  The GSW library is host C code
that cannot run inside a device program, so this module is a
from-scratch implementation of
the same published standard:

* PSS-78 (Lewis, 1980; UNESCO technical papers in marine science 44,
  Fofonoff & Millard 1983): practical salinity as a polynomial in the
  square root of the conductivity ratio Rt, with temperature and
  pressure corrections.
* Hill et al. (1986) extension for SP < 2, scaled to match PSS-78
  exactly at SP = 2 (the same algorithm GSW uses).

Conventions follow GSW: ``C`` in mS/cm, ``t`` in ITS-90 degrees C
(converted internally to IPTS-68 via t68 = t * 1.00024), ``p`` in dbar.
C(SP=35, t68=15, p=0) = 42.9140 mS/cm (Culkin & Smith, 1980).

Two implementations:

* :func:`sp_from_c_np` — NumPy float64, element-wise branch structure
  mirroring the GSW C library (used by the byte-parity engine and as the
  ``gsw`` stand-in when generating reference goldens).
* :func:`sp_from_c` — JAX, branchless (``jnp.where``), jit/vmap-safe,
  dtype-polymorphic.  NOT on the shipped decode path: round 4 moved
  science conversion + QC to the host float64 path (models.convert —
  parity-faithful by construction, and ~1-2k rows/drop is off the
  decode's critical path even at batch-64).  Kept, tested against
  sp_from_c_np over the full (C, t, p) grid, as the device alternative
  for workloads that want conversion fused on-chip (e.g. a mesh job
  post-processing profiles without a host round-trip).

Validated against the canonical UNESCO check values (R=1, t68=15, p=0 ->
SP=35 exactly; R=1.2, t68=20, p=2000 -> 37.245628; R=0.65, t68=5,
p=1500 -> 27.995347) in tests/test_seawater.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# --- PSS-78 constants (Lewis 1980 / UNESCO 44) -----------------------------
A = (0.0080, -0.1692, 25.3851, 14.0941, -7.0261, 2.7081)
B = (0.0005, -0.0056, -0.0066, -0.0375, 0.0636, -0.0144)
K = 0.0162

# rt(t): conductivity ratio of standard seawater at temperature t68, p=0
C_RT = (0.6766097, 2.00564e-2, 1.104259e-4, -6.9698e-7, 1.0031e-9)

# Rp pressure-correction coefficients
D1, D2, D3, D4 = 3.426e-2, 4.464e-4, 4.215e-1, -3.107e-3
E1, E2, E3 = 2.070e-5, -6.370e-10, 3.989e-15

# C(35, 15, 0) in mS/cm
C3515 = 42.9140

# Rtx at SP=2 as a polynomial in t68 (GSW's gsw_hill_ratio_at_sp2)
G = (
    2.641463563366498e-1,
    2.007883247811176e-4,
    -4.107694432853053e-6,
    8.401670882091225e-8,
    -1.711392021989210e-9,
    3.374193893377380e-11,
    -5.923731174730784e-13,
    8.057771569962299e-15,
    -7.054313817447962e-17,
    2.859992717347235e-19,
)

GSW_INVALID_VALUE = 9e15


def _sp_poly(rtx, ft68):
    """SP = Sum a_i Rtx^i + ft68 * Sum b_i Rtx^i (Horner form)."""
    pa = A[0] + (A[1] + (A[2] + (A[3] + (A[4] + A[5] * rtx) * rtx) * rtx) * rtx) * rtx
    pb = B[0] + (B[1] + (B[2] + (B[3] + (B[4] + B[5] * rtx) * rtx) * rtx) * rtx) * rtx
    return pa + ft68 * pb


def _dsp_drtx(rtx, ft68):
    """d(SP)/d(Rtx)."""
    da = A[1] + (2 * A[2] + (3 * A[3] + (4 * A[4] + 5 * A[5] * rtx) * rtx) * rtx) * rtx
    db = B[1] + (2 * B[2] + (3 * B[3] + (4 * B[4] + 5 * B[5] * rtx) * rtx) * rtx) * rtx
    return da + ft68 * db


def _hill_ratio_at_sp2(t68, ft68):
    """Hill et al. (1986) ratio at SP = 2 (one modified Newton iteration)."""
    rtx0 = G[9]
    for g in reversed(G[:9]):
        rtx0 = g + t68 * rtx0
    dsp = _dsp_drtx(rtx0, ft68)
    sp_est = _sp_poly(rtx0, ft68)
    rtx = rtx0 - (sp_est - 2.0) / dsp
    rtxm = 0.5 * (rtx + rtx0)
    dsp = _dsp_drtx(rtxm, ft68)
    rtx = rtx0 - (sp_est - 2.0) / dsp
    x = 400.0 * rtx * rtx
    sqrty = 10.0 * rtx
    part1 = 1.0 + x * (1.5 + x)
    part2 = 1.0 + sqrty * (1.0 + sqrty * (1.0 + sqrty))
    sp_hill_raw_at_sp2 = 2.0 - A[0] / part1 - B[0] * ft68 / part2
    return 2.0 / sp_hill_raw_at_sp2


def _core(c, t, p, xp):
    """Shared branchless computation; `xp` is numpy or jax.numpy."""
    t68 = t * 1.00024
    ft68 = (t68 - 15.0) / (1.0 + K * (t68 - 15.0))
    r = c / C3515
    rt_lc = C_RT[0] + (C_RT[1] + (C_RT[2] + (C_RT[3] + C_RT[4] * t68) * t68) * t68) * t68
    rp = 1.0 + (p * (E1 + E2 * p + E3 * p * p)) / (
        1.0 + D1 * t68 + D2 * t68 * t68 + (D3 + D4 * t68) * r
    )
    rt = r / (rp * rt_lc)
    rtx = xp.sqrt(rt)
    sp = _sp_poly(rtx, ft68)

    # Hill et al. (1986) low-salinity correction, applied where SP < 2
    hill_ratio = _hill_ratio_at_sp2(t68, ft68)
    x = 400.0 * rt
    sqrty = 10.0 * rtx
    part1 = 1.0 + x * (1.5 + x)
    part2 = 1.0 + sqrty * (1.0 + sqrty * (1.0 + sqrty))
    sp_hill = hill_ratio * (sp - A[0] / part1 - B[0] * ft68 / part2)

    sp = xp.where(sp < 2.0, sp_hill, sp)
    return rt, sp


def sp_from_c_np(c, t, p):
    """NumPy float64 Practical Salinity; mirrors GSW C semantics.

    Invalid inputs (negative conductivity ratio after pressure correction,
    or a negative computed SP) return ``GSW_INVALID_VALUE`` exactly as the
    GSW C library does; NaN inputs propagate to NaN.
    """
    c = np.asarray(c, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        rt, sp = _core(c, t, p, np)
        sp = np.where(rt < 0.0, GSW_INVALID_VALUE, sp)
        sp = np.where(sp < 0.0, GSW_INVALID_VALUE, sp)
    return sp


def sp_from_c(c, t, p):
    """JAX Practical Salinity from conductivity (mS/cm), t (ITS-90), p (dbar).

    Branchless and jit/vmap-compatible.  Works in the ambient dtype of its
    inputs (float32 on the device fast path, float64 under x64 for
    parity).
    """
    c, t, p = jnp.asarray(c), jnp.asarray(t), jnp.asarray(p)
    rt, sp = _core(c, t, p, jnp)
    sp = jnp.where(rt < 0.0, GSW_INVALID_VALUE, sp)
    sp = jnp.where(sp < 0.0, GSW_INVALID_VALUE, sp)
    return sp
