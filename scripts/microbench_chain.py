#!/usr/bin/env python3
"""Microbenchmark on the accelerator: pointer-doubling gather strategies.

Times:
  1. global squaring gathers  J = J[J]   over an M-entry int32 table
  2. within-row batched gathers (take_along_axis on (n_blk, K) rows)
  3. the production chain_enumerate at engine sizes

Each timing ends in a tiny fetch of a value that depends on the work.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from axctdprocessor_tpu.ops import chain as chain_ops

M = 1_800_000          # merged crossing-table size (600 s at 3000/s)
K = 2048               # block size for the two-level variant
LEVELS = 13            # squarings the production chain performs
REPS = 5


def timeit(fn, *args):
    out = fn(*args)          # compile + warm
    _ = float(np.asarray(jax.device_get(out)).ravel()[0])
    best = 1e9
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = float(np.asarray(jax.device_get(out)).ravel()[0])
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    print("backend:", jax.default_backend())
    rng = np.random.default_rng(0)
    # realistic successor table: advance by 1..4
    nxt = np.arange(M, dtype=np.int32) + rng.integers(1, 5, M).astype(np.int32)
    nxt = np.minimum(nxt, M - 1)

    j = jnp.asarray(nxt)

    @jax.jit
    def squarings(j):
        for _ in range(LEVELS):
            j = j[j]
        return j[:1]

    t = timeit(squarings, j)
    print(f"global squarings x{LEVELS} over {M}: {t*1e3:.1f} ms "
          f"({t/LEVELS*1e3:.2f} ms/level)")

    # blocked: same element count, gathers stay within K-length rows
    n_blk = M // K
    local = (nxt[: n_blk * K].reshape(n_blk, K) % K).astype(np.int32)
    lb = jnp.asarray(local)

    @jax.jit
    def blocked(l):
        for _ in range(LEVELS):
            l = jnp.take_along_axis(l, l, axis=1)
        return l[:1, :1]

    t2 = timeit(blocked, lb)
    print(f"blocked take_along_axis x{LEVELS} over ({n_blk},{K}): "
          f"{t2*1e3:.1f} ms ({t2/LEVELS*1e3:.2f} ms/level)")

    # production chain at engine scale
    max_edges = 600 * 800 * 5 // 4
    t3 = timeit(
        jax.jit(lambda j: chain_ops.chain_enumerate(
            j, jnp.asarray(0, jnp.int32), max_edges)[:1]), j)
    print(f"chain_enumerate M={M} k={max_edges}: {t3*1e3:.1f} ms")

    # gather-free strided variant (shifted-select delta doubling), over a
    # max_level sweep: higher levels buy shorter scan tails with more
    # shifted-select passes
    t3b = timeit(
        jax.jit(lambda j: chain_ops.chain_enumerate(
            j, jnp.asarray(0, jnp.int32), max_edges)[-1:]), j)
    print(f"chain_enumerate (tail-dependent fetch): {t3b*1e3:.1f} ms")
    for lvl in (6, 7, 8, 9):
        t5 = timeit(
            jax.jit(lambda j, lv=lvl: chain_ops.chain_enumerate_strided(
                j, jnp.asarray(0, jnp.int32), max_edges,
                max_level=lv)[-1:]), j)
        print(f"chain_enumerate_strided L={lvl} M={M} k={max_edges}: "
              f"{t5*1e3:.1f} ms")

    # stream compaction A/B: scatter (round 2) vs blocked one-hot+stitch
    for n, dens, label in ((1_038_996, 0.038, "segment-sparse"),
                           (1_986_208, 0.55, "merge-dense-front")):
        if label.endswith("front"):
            mk = np.zeros(n, bool)
            # front-loaded runs like the assemble merge sees
            for s in range(0, n, 70936):
                mk[s: s + 38000] = True
        else:
            mk = rng.random(n) < dens
        size = max(int(n * 0.07), 70936) if dens < 0.5 else n
        mkd = jnp.asarray(mk)
        ts = timeit(jax.jit(
            lambda m, s=size: chain_ops.compact_indices(
                m, s, 2**30)[0][-1:]), mkd)
        tb = timeit(jax.jit(
            lambda m, s=size: chain_ops.compact_indices_blocked(
                m, s, 2**30)[0][-1:]), mkd)
        print(f"compact {label} n={n} size={size}: "
              f"scatter {ts*1e3:.1f} ms, blocked {tb*1e3:.1f} ms")

    # frame sync at engine scale (accept-compacted domain)
    M2 = 600_000
    accept = rng.random(M2) < 0.04
    accept[1:] &= ~accept[:-1]
    acc = jnp.asarray(accept)
    t4 = timeit(
        jax.jit(lambda a: chain_ops.enumerate_frames(
            a, M2, max_steps=M2, max_frames=M2 // 32 + 8)[0][:1]), acc)
    print(f"enumerate_frames n={M2}: {t4*1e3:.1f} ms")


if __name__ == "__main__":
    import os as _os, sys as _sys
    _sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))
    from _artifact import record_report

    record_report("chain", main)
