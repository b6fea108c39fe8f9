"""Streaming (push-based) decode must equal whole-file decode exactly."""

import numpy as np
import pytest

from axctdprocessor_tpu.models.parity_engine import decode_waveform
from axctdprocessor_tpu.models.stream import AXCTDStreamDecoder
from axctdprocessor_tpu.utils.wavio import read_wav


@pytest.mark.parametrize("chunking", ["uniform_1s", "ragged", "tiny_then_huge"])
def test_stream_equals_batch(default_drop_wav, rng, chunking):
    wav, _ = default_drop_wav
    pcm, fs = read_wav(wav)
    batch = decode_waveform(pcm, fs)

    dec = AXCTDStreamDecoder(fs)
    pos = 0
    while pos < len(pcm):
        if chunking == "uniform_1s":
            step = int(fs)
        elif chunking == "ragged":
            step = int(rng.integers(1000, 150000))
        else:
            step = 777 if pos < 10000 else len(pcm)
        dec.feed(pcm[pos : pos + step])
        pos += step
    res = dec.finalize()

    assert res.status == batch.status
    assert res.firstpulse400 == batch.firstpulse400
    assert res.profstartind == batch.profstartind
    assert res.metadata == batch.metadata
    assert res.hexframes == batch.hexframes
    np.testing.assert_array_equal(np.asarray(res.time), np.asarray(batch.time))
    np.testing.assert_array_equal(
        np.asarray(res.salinity), np.asarray(batch.salinity))


def test_latest_rows_incremental(default_drop_wav):
    wav, _ = default_drop_wav
    pcm, fs = read_wav(wav)
    dec = AXCTDStreamDecoder(fs)
    seen = 0
    got_rows_midstream = False
    for pos in range(0, len(pcm), int(2 * fs)):
        dec.feed(pcm[pos : pos + int(2 * fs)])
        rows = dec.latest_rows()
        seen += len(rows)
        if rows and pos < len(pcm) - int(4 * fs):
            got_rows_midstream = True
    dec.finalize()
    seen += len(dec.latest_rows())
    assert got_rows_midstream, "rows should appear before end of stream"
    batch = decode_waveform(pcm, fs)
    assert seen == len(batch.time)


def test_feed_after_finalize_raises(default_drop_wav):
    wav, _ = default_drop_wav
    pcm, fs = read_wav(wav)
    dec = AXCTDStreamDecoder(fs)
    dec.feed(pcm[: int(5 * fs)])
    dec.finalize()
    with pytest.raises(RuntimeError):
        dec.feed(pcm[: 100])


def test_checkpoint_resume(default_drop_wav, tmp_path):
    """Snapshot mid-stream, resume from disk -> identical final decode."""
    wav, _ = default_drop_wav
    pcm, fs = read_wav(wav)
    cut = int(20 * fs)

    ref = AXCTDStreamDecoder(fs)
    ref.feed(pcm[:cut])
    ref.feed(pcm[cut:])
    expected = ref.finalize()

    dec = AXCTDStreamDecoder(fs)
    dec.feed(pcm[:cut])
    ckpt = str(tmp_path / "decoder.ckpt")
    dec.save_checkpoint(ckpt)
    del dec

    resumed = AXCTDStreamDecoder.load_checkpoint(ckpt)
    resumed.feed(pcm[cut:])
    res = resumed.finalize()

    assert res.metadata == expected.metadata
    assert res.hexframes == expected.hexframes
    np.testing.assert_array_equal(np.asarray(res.time), np.asarray(expected.time))
    np.testing.assert_array_equal(
        np.asarray(res.salinity), np.asarray(expected.salinity))


# ---------------------------------------------------------------------------
# Device streaming (models.stream_tpu): push API over the segmented
# engine — fed piecewise, the finalized result must be IDENTICAL to the
# offline segmented decode of the concatenated stream.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_drop130():
    from axctdprocessor_tpu.models import simulator

    spec = simulator.SimSpec(duration=130.0, profile_start=33.0, seed=91)
    pcm, truth = simulator.synthesize(spec)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    return x, truth


@pytest.mark.slow
def test_tpu_stream_equals_offline_segmented(stream_drop130):
    from axctdprocessor_tpu.models import segmented
    from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

    x, truth = stream_drop130
    offline = segmented.decode_waveform_segmented(x, 44100)

    # one plain decoder and one pinned (max_duration) decoder: pin
    # padding must not change the decode, and the pinned stream must
    # never recompile mid-stream
    from axctdprocessor_tpu.models import segmented as seg_mod

    dec = TPUStreamDecoder(44100)
    pinned = TPUStreamDecoder(44100, max_duration=200.0)
    n0 = seg_mod._assemble_program.cache_info().misses
    step = int(2.0 * 44100)  # ~2 s receiver blocks
    for i in range(0, len(x), step):
        dec.feed(x[i:i + step])
        pinned.feed(x[i:i + step])
    # feeding never builds assemble programs (segment programs only)
    assert seg_mod._assemble_program.cache_info().misses == n0
    res = dec.finalize()
    # the plain decoder builds at most its one m*2^e bucket at finalize
    # (the offline decode above uses the grouped CHUNKED assemble, so it
    # no longer pre-warms this cache — a fresh xdist worker misses once)
    n1 = seg_mod._assemble_program.cache_info().misses
    assert n1 - n0 <= 1
    res_pin = pinned.finalize()
    # the pinned decoder compiled its one program at construction: no
    # recompilation mid-stream OR at finalize
    assert seg_mod._assemble_program.cache_info().misses == n1

    for r in (res, res_pin):
        assert r.status == offline.status == 2
        assert r.metadata == offline.metadata
        assert r.hexframes == offline.hexframes
        assert r.time == offline.time
        assert r.temperature == offline.temperature
        assert r.salinity == offline.salinity
        assert r.firstpulse400 == offline.firstpulse400
        assert r.profstartind == offline.profstartind
        assert r.numpoints == offline.numpoints
        assert r.metadata["serial_no"] == truth["serial_no"]


@pytest.mark.slow
def test_tpu_stream_pinned_bucket_no_midstream_compiles():
    """max_duration pins one max-bucket assemble program, compiled at
    construction: NO snapshot or finalize may miss the program cache
    afterwards (a fresh mid-stream compile would stall a live
    receiver)."""
    from axctdprocessor_tpu.models import segmented
    from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

    dec = TPUStreamDecoder(44100, max_duration=25.0)
    pin = dec._pin_bucket
    assert pin >= int(np.ceil(25.0 * 44100 / dec._seg_len))
    seg_info = segmented._segment_program.cache_info()
    asm_info = segmented._assemble_program.cache_info()

    dec.results()                       # pre-segment snapshot
    dec.feed(np.zeros(1000, np.float32))
    dec.results()                       # mid-stream snapshot
    res = dec.finalize()                # tail flush + final assemble

    assert segmented._segment_program.cache_info().misses == seg_info.misses
    assert segmented._assemble_program.cache_info().misses == asm_info.misses
    assert res.status == 0  # silence: no trigger, but a clean result


@pytest.mark.slow
def test_tpu_stream_incremental_results(stream_drop130):
    """Rows become available as segments complete, and grow monotonically
    toward the final decode."""
    from axctdprocessor_tpu.models.stream_tpu import TPUStreamDecoder

    x, truth = stream_drop130
    dec = TPUStreamDecoder(44100)
    step = int(2.0 * 44100)
    rows_at = []
    for i in range(0, len(x), step):
        n_seg = dec.feed(x[i:i + step])
        # poll a snapshot when a new segment lands (coarse UI rate)
        if rows_at and n_seg == rows_at[-1][0]:
            continue
        snap = dec.results()
        rows_at.append((n_seg, len(snap.time)))
    final = dec.finalize()
    counts = [r for _, r in rows_at]
    assert counts == sorted(counts), "rows must grow monotonically"
    assert counts[-1] > 0, "rows must appear before end of stream"
    assert len(final.time) >= counts[-1]
    assert final.metadata["serial_no"] == truth["serial_no"]
    # feeding after finalize is an error (stream contract)
    with pytest.raises(RuntimeError):
        dec.feed(x[:10])
