"""Decode engines and signal models.

* :mod:`.simulator` — synthetic AXCTD signal encoder (FSK + frame/CRC +
  header encoder), the inverse of the decode pipeline; the framework's
  test-fixture generator and a model of the probe itself.
* :mod:`.parity_engine` — reference-exact streaming decoder (host).
* :mod:`.tpu_engine` — whole-waveform fused device decoder.
"""
