"""Corpus reprocessing: bucketing, prefetch, manifest checkpoint/resume."""

import json
import os

import numpy as np
import pytest

from axctdprocessor_tpu.models import simulator
from axctdprocessor_tpu.parallel.archive import reprocess_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i in range(3):
        spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=50 + i)
        pcm, _ = simulator.synthesize(spec)
        p = str(d / f"drop{i}.wav")
        simulator.write_wav(p, pcm, spec.fs)
        paths.append(p)
    return paths


@pytest.mark.slow
def test_reprocess_corpus(corpus, tmp_path):
    out = str(tmp_path / "out")
    manifest = reprocess_corpus(corpus, out, batch_size=2)
    assert all(v["status"] == "done" for v in manifest["files"].values())
    for p in corpus:
        name = os.path.splitext(os.path.basename(p))[0] + ".txt"
        text = open(os.path.join(out, name)).read()
        assert "Probe Serial: 00123456" in text
        assert text.count("\n") > 100
    assert "device.dispatch_batch" in manifest["stage_times"]
    assert "device.fetch_batch" in manifest["stage_times"]


@pytest.mark.slow  # ~170 s: two full corpus passes; quarantine/manifest behavior stays fast-gated
def test_resume_skips_done(corpus, tmp_path):
    out = str(tmp_path / "out2")
    reprocess_corpus(corpus[:2], out, batch_size=2)
    m1 = json.load(open(os.path.join(out, "manifest.json")))
    assert len(m1["files"]) == 2
    # second run with the full corpus only processes the missing drop
    m2 = reprocess_corpus(corpus, out, batch_size=2, resume=True)
    assert len(m2["files"]) == 3
    done1 = {k: v["finished_at"] for k, v in m1["files"].items()}
    for k, t in done1.items():
        assert m2["files"][k]["finished_at"] == t, "re-decoded a done file"


def test_cli_corpus_mode(corpus, tmp_path):
    from axctdprocessor_tpu import cli

    out = str(tmp_path / "cli_out")
    rc = cli.main(["--corpus", os.path.dirname(corpus[0]), "-o", out,
                   "--batch-size", "2", "--quiet"])
    assert rc == 0
    assert len(os.listdir(out)) == 4  # 3 reports + manifest


@pytest.mark.slow
def test_cli_corpus_wire_and_diagnostics(corpus, tmp_path):
    """--corpus must honor --wire and --diagnostics: the resolved wire
    reaches dispatch_batch (recorded per file in the manifest) and the
    reports carry the diagnostics columns + wire attribution."""
    from axctdprocessor_tpu import cli

    out = str(tmp_path / "cli_wire_out")
    rc = cli.main(["--corpus", os.path.dirname(corpus[0]), "-o", out,
                   "--batch-size", "2", "--quiet", "--wire", "int4",
                   "--diagnostics"])
    assert rc == 0
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert manifest["files"], "corpus produced no manifest entries"
    for name, entry in manifest["files"].items():
        assert entry.get("wire") == "int4", name
    text = open(os.path.join(out, "drop0.txt")).read()
    assert "Wire format: int4" in text
    assert ", R400, dR7500" in text
    assert "Probe Serial: 00123456" in text  # int4 decode still correct


def test_stage_timer():
    import time as _t

    from axctdprocessor_tpu.utils.profiling import StageTimer

    t = StageTimer()
    with t.stage("a"):
        _t.sleep(0.01)
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    d = t.as_dict()
    assert d["a"] >= 0.01 and t.counts["a"] == 2
    assert "a" in t.report() and "b" in t.report()


def test_corrupt_file_quarantined(corpus, tmp_path):
    bad = str(tmp_path / "corrupt.wav")
    open(bad, "wb").write(b"RIFFgarbage_that_is_not_a_wav")
    out = str(tmp_path / "out3")
    manifest = reprocess_corpus([corpus[0], bad], out, batch_size=2)
    names = {os.path.basename(corpus[0]): "done", "corrupt.wav": "failed"}
    for name, status in names.items():
        assert manifest["files"][name]["status"] == status, name


@pytest.mark.slow
def test_mixed_sample_rates(corpus, tmp_path):
    """Files with different fs must never share a decode batch."""
    from axctdprocessor_tpu.models import simulator as sim

    spec = sim.SimSpec(fs=22050, duration=40.0, profile_start=33.0, seed=60)
    pcm, truth = sim.synthesize(spec)
    p22 = str(tmp_path / "drop22k.wav")
    sim.write_wav(p22, pcm, spec.fs)
    out = str(tmp_path / "out_mixed")
    manifest = reprocess_corpus([corpus[0], p22, corpus[1]], out, batch_size=3)
    assert all(v["status"] == "done" for v in manifest["files"].values())
    for name in ("drop0.txt", "drop22k.txt"):
        text = open(os.path.join(out, name)).read()
        assert "Probe Serial: 00123456" in text, name
    assert "Sampling frequency (fs): 22050 Hz" in open(
        os.path.join(out, "drop22k.txt")).read()


def test_multihost_partition_disjoint_and_balanced(tmp_path):
    from axctdprocessor_tpu.parallel.multihost import partition_corpus

    paths = []
    rng = np.random.default_rng(4)
    for i in range(23):
        p = str(tmp_path / f"f{i:02d}.wav")
        open(p, "wb").write(b"x" * int(rng.integers(1000, 100000)))
        paths.append(p)

    slices = [partition_corpus(paths, k, 4) for k in range(4)]
    all_assigned = [p for s in slices for p in s]
    assert sorted(all_assigned) == sorted(paths)          # disjoint + complete
    assert len(set(all_assigned)) == len(paths)
    sizes = [sum(os.path.getsize(p) for p in s) for s in slices]
    assert max(sizes) < 2.0 * max(min(sizes), 1)          # roughly balanced
    # single host owns everything
    assert partition_corpus(paths, 0, 1) == paths


def test_multihost_single_process(corpus, tmp_path):
    from axctdprocessor_tpu.parallel.multihost import reprocess_corpus_multihost

    out = str(tmp_path / "mh_out")
    manifest = reprocess_corpus_multihost(corpus[:1], out, batch_size=2)
    assert list(manifest["files"].values())[0]["status"] == "done"

@pytest.mark.slow
def test_mixed_encoding_batch_not_demoted(corpus, tmp_path):
    """One float-path (stereo) or corrupt file must not demote the whole
    batch off the raw-int16 path or abort it — per-file fallback only."""
    from scipy.io import wavfile

    # stereo copy of drop0 -> needs the full conditioning (float) path
    fs, snd = wavfile.read(corpus[0])
    stereo = str(tmp_path / "stereo.wav")
    wavfile.write(stereo, fs, np.stack([snd, snd], axis=1))
    bad = str(tmp_path / "corrupt2.wav")
    open(bad, "wb").write(b"RIFFnot_really_a_wav_file")

    out = str(tmp_path / "out_mixed_enc")
    manifest = reprocess_corpus([corpus[0], stereo, bad, corpus[1]], out,
                                batch_size=4)
    files = manifest["files"]
    assert files["corrupt2.wav"]["status"] == "failed"
    assert "error" in files["corrupt2.wav"]
    for name in ("drop0.txt", "stereo.txt", "drop1.txt"):
        text = open(os.path.join(out, name)).read()
        assert "Probe Serial: 00123456" in text, name

@pytest.mark.slow
def test_multihost_two_process_jax_distributed(corpus, tmp_path):
    """Real jax.distributed coordination: a coordinator + worker process
    pair on localhost each decode their disjoint corpus slice; merged
    manifests cover the whole corpus exactly once."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "mh")
    code = """
import json, sys
from axctdprocessor_tpu.parallel.multihost import reprocess_corpus_multihost
paths = json.loads(sys.argv[1])
m = reprocess_corpus_multihost(
    paths, sys.argv[2], coordinator=sys.argv[3],
    num_processes=2, process_id=int(sys.argv[4]), batch_size=2)
print("HOST_DONE", sys.argv[4], len(m["files"]))
"""
    import json as _json
    import os as _os

    env = dict(_os.environ)  # conftest already set JAX_PLATFORMS=cpu
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, _json.dumps(corpus), out,
             f"127.0.0.1:{port}", str(k)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for k in (0, 1)
    ]
    logs = []
    for p in procs:
        # generous: ~200 s alone on this 1-core host, but 2x+ under
        # xdist/load (timed out at 420 s twice in full-suite runs)
        out_text, _ = p.communicate(timeout=1200)
        logs.append(out_text)
        assert p.returncode == 0, out_text[-2000:]

    merged = {}
    for k in (0, 1):
        man = json.load(open(os.path.join(out, f"host{k}", "manifest.json")))
        for name, entry in man["files"].items():
            assert name not in merged, f"{name} decoded on both hosts"
            merged[name] = entry
    assert set(merged) == {os.path.basename(p) for p in corpus}
    assert all(v["status"] == "done" for v in merged.values()), logs
