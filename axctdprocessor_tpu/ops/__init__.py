"""Numeric kernels: DSP, codec, and science-conversion primitives.

Each module provides a NumPy float64 implementation (used by the
byte-parity engine) and, where the op is on the device hot path, a JAX
implementation (matrix products, `lax` scans, pointer-doubling chains).
"""
