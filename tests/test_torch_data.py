"""The port's real-data side on the CPU against the JAX package: the
length-bucket sampler, ``resample``, the WAV parser and the numpy loader
(equal), the native loader (built with g++ into ``build/audioloader/``:
batch shapes, gains, eval-mode crops), ``make_audio_loader``'s refusal to
fall back quietly, and ``scripts/prepare_dataset_torch.py`` on a small
codec. WAV files and shards are made in the test from a seed."""
import importlib.util
import os
import struct
import wave

import numpy as np
import pytest
import torch

from lina_speech_tpu.data import audio_loader as jloader
from lina_speech_tpu.data.dataset import LengthBucketSampler as JaxSampler
from lina_speech_tpu.data.resample import resample as jax_resample
from lina_speech_tpu_torch.data import audio_loader as tloader
from lina_speech_tpu_torch.data.dataset import LengthBucketSampler, TokenizedTTSDataset
from lina_speech_tpu_torch.data.resample import resample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_pcm16(path, x, sr=24000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def write_riff(path, x, code, bits, sr=24000, channels=1, extra_chunk=False):
    """A RIFF/WAVE file of ``x`` (frames x channels flattened) as format
    ``code`` (1 PCM, 3 IEEE float) at ``bits``; ``extra_chunk`` puts an
    odd-sized LIST chunk (padded to even) before the data."""
    if code == 3:
        data = x.astype("<f4").tobytes()
    else:
        full = 2 ** (bits - 1) - 1
        data = (np.clip(x.astype(np.float64), -1, 1) * full).astype(f"<i{bits // 8}").tobytes()
    block = channels * bits // 8
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, code, channels, sr, sr * block, block, bits)
    extra = b"LIST" + struct.pack("<I", 3) + b"abc\x00" if extra_chunk else b""
    body = fmt + extra + b"data" + struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


@pytest.fixture
def wavs(tmp_path):
    """Three PCM16 files and one float32 file of seeded noise at different
    lengths and levels."""
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((4000, 2500, 5000)):
        p = tmp_path / f"a{i}.wav"
        write_pcm16(p, rng.normal(size=n).astype(np.float32) * (0.1 + 0.1 * i))
        paths.append(str(p))
    p = tmp_path / "f32.wav"
    write_riff(p, rng.normal(size=3000).astype(np.float32) * 0.3, code=3, bits=32)
    paths.append(str(p))
    return paths


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("kw", [dict(), dict(max_tokens=120, max_batch_size=5, seed=2),
                                dict(max_tokens=64, max_batch_size=3, shuffle=False),
                                dict(max_tokens=200, max_batch_size=2, seed=7)], ids=str)
def test_length_bucket_sampler_equals_the_jax_package(kw):
    lengths = np.random.default_rng(1).integers(3, 60, size=53)
    ours, theirs = LengthBucketSampler(lengths, **kw), JaxSampler(lengths, **kw)
    budget = kw.get("max_tokens", 8192)
    epochs = []
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert a == b and len(ours) == len(theirs) == len(a)
        assert sorted(i for batch in a for i in batch) == list(range(len(lengths)))
        for batch in a:
            assert len(batch) <= kw.get("max_batch_size", 64)
            assert len(batch) == 1 or max(lengths[batch]) * len(batch) <= budget
        epochs.append(a)
    if kw.get("shuffle", True):
        assert epochs[0] != epochs[1]  # the per-epoch reseed
    else:
        assert epochs[0] == epochs[1]


def test_dataset_reads_its_own_shards(tmp_path):
    rng = np.random.default_rng(3)
    items = [{"audio_token": rng.integers(0, 50, (2, n)), "text": f"utt {n}"}
             for n in (4, 9, 6)]
    TokenizedTTSDataset.save_npz(str(tmp_path / "a.npz"), items[:2])
    TokenizedTTSDataset.save_npz(str(tmp_path / "b.npz"), items[2:])
    ds = TokenizedTTSDataset(items=[items[0]], npz_paths=[str(tmp_path / "a.npz"),
                                                          str(tmp_path / "b.npz")])
    assert len(ds) == 4 and list(ds.lengths()) == [4, 4, 9, 6]
    for got, want in zip(ds.items[1:], items):
        assert got["text"] == want["text"]
        np.testing.assert_array_equal(got["audio_token"], want["audio_token"])


# --------------------------------------------------------------- resample
@pytest.mark.parametrize("orig,target,shape,dtype", [
    (16000, 24000, (3001,), np.float32), (44100, 24000, (2, 4410), np.float32),
    (24000, 16000, (999,), np.float64), (22050, 24000, (1, 2205), np.float32),
    (24000, 24000, (100,), np.float32)], ids=str)
def test_resample_equals_the_jax_package(orig, target, shape, dtype):
    x = np.random.default_rng(2).normal(size=shape).astype(dtype)
    ours, theirs = resample(x, orig, target), jax_resample(x, orig, target)
    assert ours.dtype == theirs.dtype == dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    if orig != target:
        assert ours.shape[-1] == -(-shape[-1] * target // orig)


# --------------------------------------------------------------- the WAV parser
@pytest.mark.parametrize("code,bits,channels,extra", [
    (1, 16, 1, False), (3, 32, 1, False), (1, 32, 1, False), (1, 16, 2, True),
    (3, 32, 2, True)], ids=["pcm16", "float32", "pcm32", "pcm16-stereo-list", "f32-stereo-list"])
def test_wav_parser_equals_the_jax_package(tmp_path, code, bits, channels, extra):
    x = np.random.default_rng(4).normal(size=1201 * channels).astype(np.float32) * 0.4
    path = tmp_path / "x.wav"
    if code == 1 and bits == 16 and not extra:
        write_pcm16(path, x, channels=channels)
    else:
        write_riff(path, x, code, bits, channels=channels, extra_chunk=extra)
    ours = tloader.NumpyAudioLoader._read(str(path))
    theirs = jloader.NumpyAudioLoader([], 0, 0)._read(str(path))
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (1201,)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(tloader.read_wav(str(path)), ours)
    want = (x if code == 3 else np.clip(x, -1, 1)).reshape(-1, channels).mean(axis=1)
    assert float(np.abs(ours - want).max()) < (2.0 ** -14 if bits == 16 else 1e-6)


def test_wav_parser_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + b"\x00" * 40)
    with pytest.raises(ValueError, match="not a RIFF"):
        tloader.read_wav(str(bad))
    pcm8 = tmp_path / "pcm8.wav"
    write_riff(pcm8, np.zeros(8, np.float32), code=1, bits=8)
    with pytest.raises(ValueError, match="unsupported wav format"):
        tloader.read_wav(str(pcm8))


def test_numpy_loader_equals_the_jax_package(wavs):
    for train in (True, False):
        ours = tloader.NumpyAudioLoader(wavs, crop_len=3200, batch=3, seed=5, train=train)
        theirs = jloader.NumpyAudioLoader(wavs, crop_len=3200, batch=3, seed=5, train=train)
        for _ in range(3):
            np.testing.assert_array_equal(next(ours), next(theirs))


# ------------------------------------------------------------- the native loader
def test_native_loader_batches(wavs):
    with tloader.NativeAudioLoader(wavs, crop_len=1024, batch=4, n_threads=3, seed=1) as loader:
        for _ in range(4):
            batch = next(loader)
            assert batch.shape == (4, 1024) and batch.dtype == np.float32
            assert np.isfinite(batch).all()
            peaks = np.abs(batch).max(axis=1)
            # gain-normalized to -6..-1 dBFS of the file's peak (the crop's
            # peak may sit below the file's)
            assert (peaks > 0).all() and (peaks <= 10 ** (-1 / 20) * 1.0001).all()
    assert os.path.dirname(tloader.build_native()) == str(tloader.build_dir())


def test_native_loader_eval_crops_from_the_start(wavs):
    """``train=False``: every row is a file's first ``crop_len`` samples
    (zero-padded past its end) times one gain in -6..-1 dB of its peak."""
    files = [tloader.read_wav(p) for p in wavs]
    crop = 3600  # longer than two of the files
    with tloader.make_audio_loader(wavs, crop, 6, n_threads=2, seed=3, train=False) as loader:
        assert isinstance(loader, tloader.NativeAudioLoader)
        rows = np.concatenate([next(loader) for _ in range(3)])
    seen = set()
    for row in rows:
        for i, x in enumerate(files):
            head = np.zeros(crop, np.float32)
            head[:min(crop, len(x))] = x[:crop]
            gain = float(row @ head) / float(head @ head)
            if np.allclose(row, gain * head, rtol=1e-5, atol=1e-6):
                db = 20 * np.log10(gain * np.abs(x).max())
                assert -6.0001 <= db <= -0.9999, db
                seen.add(i)
                break
        else:
            raise AssertionError("a row that is no file's head crop")
    assert len(seen) >= 2


def test_make_audio_loader_raises_instead_of_falling_back(wavs, tmp_path, monkeypatch):
    """A native loader that does not build raises; numpy only on request."""
    broken = tmp_path / "audioloader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tloader, "SRC_PATH", broken)
    monkeypatch.setattr(tloader, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tloader.make_audio_loader(wavs, 256, 2)
    loader = tloader.make_audio_loader(wavs, 256, 2, loader="numpy", n_threads=4, seed=0)
    assert isinstance(loader, tloader.NumpyAudioLoader) and next(loader).shape == (2, 256)
    with pytest.raises(ValueError, match="unknown loader"):
        tloader.make_audio_loader(wavs, 256, 2, loader="soundfile")


# ------------------------------------------------------------ dataset preparation
def _prepare_module():
    spec = importlib.util.spec_from_file_location(
        "prepare_dataset_torch", os.path.join(ROOT, "scripts", "prepare_dataset_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prepare_dataset_writes_the_codec_codes(tmp_path):
    """A manifest of four WAVs (PCM16 and float32, one at 16 kHz named
    ``@16000``) through ``prepare`` on a small codec: two shards of codes
    equal to the codec's own encode of the resampled, hop-padded audio."""
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer

    prep = _prepare_module()
    wavtok = build_wavtokenizer(WavTokenizerConfig(
        ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
        backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8),
        device="cpu", seed=1)
    rng = np.random.default_rng(6)
    lines = []
    for i, (n, name) in enumerate(((83, "a.wav"), (64, "b.wav"), (50, "c@16000.wav"),
                                   (97, "d.wav"))):
        x = (0.3 * rng.normal(size=n)).astype(np.float32)
        path = tmp_path / name
        write_pcm16(path, x) if i % 2 == 0 else write_riff(path, x, code=3, bits=32)
        lines.append(f"{path}\tutterance {i}\n")
    manifest = tmp_path / "files.tsv"
    manifest.write_text("".join(lines[:2]) + "\n" + "".join(lines[2:]))
    shards, n = prep.prepare(wavtok, str(manifest), str(tmp_path / "out"), shard_size=3,
                             sample_rate=24000)
    assert n == 4 and [os.path.basename(s) for s in shards] == ["shard_00000.npz",
                                                                "shard_00001.npz"]
    ds = TokenizedTTSDataset(npz_paths=shards)
    assert [it["text"] for it in ds.items] == [f"utterance {i}" for i in range(4)]
    for line, item in zip(lines, ds.items):
        path = line.split("\t")[0]
        audio = tloader.read_wav(path)
        if "@" in path:
            audio = resample(audio, 16000, 24000)
            assert len(audio) == 75
        audio = np.pad(audio, (0, (-len(audio)) % 8))
        np.testing.assert_array_equal(prep.load_utterance(path, 24000, 8), audio)
        with torch.no_grad():
            want = wavtok.encode(torch.from_numpy(audio)[None])[1][:, 0].numpy()
        assert item["audio_token"].shape == (1, len(audio) // 8)
        np.testing.assert_array_equal(item["audio_token"], want)
