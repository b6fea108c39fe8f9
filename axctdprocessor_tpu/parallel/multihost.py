"""Multi-host (DCN) corpus sharding for very large archive jobs.

Pattern: drops are *embarrassingly parallel*, so multi-host scaling is
data partitioning over DCN rather than model sharding — each host runs
its own single-host archive job (meshes via parallel.batch/timeshard)
over a deterministic, disjoint slice of the corpus.  Hosts only need to
agree on the file list; results land as per-drop reports + per-host
manifests that merge trivially.

`jax.distributed.initialize()` is the entry point on a real multi-host
slice; in single-process environments (this container, CI) the partition
logic degrades to host 0 owning everything, which is what the unit tests
exercise.  Size balancing uses a greedy longest-first bin packing over
file sizes so hosts finish together even with mixed-length drops.
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed if configured; returns (process_id, count).

    With no coordinator (single-host), returns (0, 1) without touching
    the runtime.
    """
    import jax

    if coordinator:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def partition_corpus(wav_paths: list[str], process_id: int,
                     process_count: int) -> list[str]:
    """This host's slice of the corpus: greedy size-balanced, deterministic.

    Every host computes the same assignment from the same sorted file
    list (no communication needed), and the slices are disjoint and
    cover the corpus.
    """
    if process_count <= 1:
        return list(wav_paths)

    def size_of(p):
        try:
            return os.path.getsize(p)
        except OSError:
            return 0

    ranked = sorted(sorted(wav_paths), key=size_of, reverse=True)
    loads = [0] * process_count
    mine = []
    for path in ranked:
        target = loads.index(min(loads))
        loads[target] += max(size_of(path), 1)
        if target == process_id:
            mine.append(path)
    return mine


def reprocess_corpus_multihost(wav_paths: list[str], out_dir: str,
                               coordinator: str | None = None,
                               num_processes: int | None = None,
                               process_id: int | None = None,
                               **kwargs) -> dict:
    """Archive reprocessing across hosts: partition, then run this host's
    share with parallel.archive (per-host manifest under out_dir/host<k>)."""
    from .archive import reprocess_corpus

    pid, count = init_distributed(coordinator, num_processes, process_id)
    mine = partition_corpus(wav_paths, pid, count)
    host_dir = os.path.join(out_dir, f"host{pid}") if count > 1 else out_dir
    return reprocess_corpus(mine, host_dir, **kwargs)
