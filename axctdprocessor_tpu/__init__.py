"""axctdprocessor_tpu — an AXCTD audio decoding framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the
AXCTDprocessor reference (cdens/AXCTDprocessor): decoding Airborne
eXpendable Conductivity-Temperature-Depth (AXCTD) probe audio — an
800-baud FSK bitstream (mark 400 Hz / space 800 Hz) in a VHF FM
downlink recording — into temperature/conductivity/salinity/depth
profiles.

Two decode engines are provided:

* ``models.parity_engine`` — a host-orchestrated streaming state machine
  that is byte-identical to the reference CLI's ``output.txt`` (including
  its chunk semantics; see reference AXCTDprocessor.py:267-338).
* ``models.tpu_engine`` — a whole-waveform fused decoder for an
  accelerator (the GPU): framed multi-tone DFT powers as matrix
  products, FFT-domain filtering, pointer-doubling bit-edge chaining
  and frame sync, vectorized CRC-6, and a JAX port of PSS-78
  ``SP_from_C``.

``parallel`` adds batched (vmap) multi-drop decode and mesh-sharded
archive reprocessing (data-parallel over drops, sequence-parallel over
the time axis with halo exchange).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "decode_wav": ("axctdprocessor_tpu.models.parity_engine", "decode_wav"),
    "decode_waveform": ("axctdprocessor_tpu.models.parity_engine", "decode_waveform"),
    "decode_wav_tpu": ("axctdprocessor_tpu.models.tpu_engine", "decode_wav_tpu"),
    "decode_waveform_tpu": ("axctdprocessor_tpu.models.tpu_engine", "decode_waveform_tpu"),
    "decode_batch": ("axctdprocessor_tpu.parallel.batch", "decode_batch"),
    "decode_batches_pipelined": (
        "axctdprocessor_tpu.parallel.pipeline", "decode_batches_pipelined"),
    "reprocess_corpus": ("axctdprocessor_tpu.parallel.archive", "reprocess_corpus"),
    "AXCTDStreamDecoder": ("axctdprocessor_tpu.models.stream", "AXCTDStreamDecoder"),
    "TPUStreamDecoder": ("axctdprocessor_tpu.models.stream_tpu", "TPUStreamDecoder"),
    "decode_waveform_segmented": (
        "axctdprocessor_tpu.models.segmented", "decode_waveform_segmented"),
    "prestage_waveform": (
        "axctdprocessor_tpu.models.segmented", "prestage_waveform"),
    "PrestagedDrop": ("axctdprocessor_tpu.models.segmented", "PrestagedDrop"),
    "DecoderConfig": ("axctdprocessor_tpu.utils.config", "DecoderConfig"),
    "resolve_settings": ("axctdprocessor_tpu.utils.config", "resolve_settings"),
}


def __getattr__(name):
    """Lazy top-level API (avoids importing JAX for CLI-help-only runs)."""
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
