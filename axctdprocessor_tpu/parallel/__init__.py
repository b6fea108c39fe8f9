"""Scale-out: batched multi-drop decode (DP) and time-axis sharding (SP).

The reference is strictly single-threaded (SURVEY.md 2.5); these are the
device scale axes promoted to first-class components:

* :mod:`.mesh` — device mesh construction and sharding helpers;
* :mod:`.batch` — vmapped multi-drop decode, data-parallel over a mesh
  axis (the archive-reprocessing path);
* :mod:`.timeshard` — one long waveform's time axis sharded across
  devices with halo exchange (``ppermute``) for filter warm-up
  and window overlap — the DSP analog of ring-attention block overlap;
* :mod:`.pipeline` — two-stage front-end/back-half placement across
  devices with async device-to-device copies between;
* :mod:`.archive` — corpus reprocessing with length bucketing, threaded
  read-ahead, dispatch/fetch software pipelining, and manifest
  checkpoint/resume;
* :mod:`.multihost` — jax.distributed corpus sharding across hosts
  (deterministic size-balanced partitioner).
"""
