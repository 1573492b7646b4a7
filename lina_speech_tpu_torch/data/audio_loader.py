"""ctypes wrapper over the port's native C++ audio loader
(``native/audioloader.cpp``), and the same loader in numpy.

The port's own copy of ``lina_speech_tpu/data/audio_loader.py``: WAV
decode, random crop and random gain normalization for codec / vocoder
training, in native worker threads off the interpreter lock (the
reference's torch DataLoader + soundfile path, decoder/dataset.py).

One difference by design: :func:`make_audio_loader` takes the native loader
and raises when it does not build; it falls back to numpy only when the
caller asks for it (``loader="numpy"``), where the JAX package's falls back
quietly.

The library is built with ``g++`` at first use into
``build/audioloader/`` beside the package (never into the source tree),
under a name that carries a hash of the source, so an edited source
rebuilds and a built one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Iterator, List

import numpy as np

SRC_PATH = Path(__file__).resolve().parents[1] / "native" / "audioloader.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def build_dir() -> Path:
    """``build/audioloader`` beside the package (the repository root in a
    checkout), next to the CUDA kernels' ``build/torch_kernels``."""
    return SRC_PATH.parents[2] / "build" / "audioloader"


def build_native() -> str:
    """Compile the shared library unless one of the same source exists;
    returns its path. Raises ``RuntimeError`` with the compiler's output
    when ``g++`` is missing or fails."""
    digest = hashlib.sha256(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode())
    out = build_dir() / f"libaudioloader-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC_PATH), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native audio loader: cannot run g++ ({e})") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native audio loader: g++ failed:\n{e.stderr}") from e
    os.replace(tmp, out)  # atomic: concurrent builders each write their own tmp
    return str(out)


class NativeAudioLoader:
    """Iterator of (batch, crop_len) float32 audio batches drawn by
    ``n_threads`` native workers. ``train=False`` crops every file from its
    start (evaluation); the gain is drawn in both modes, as in training."""

    def __init__(self, paths: List[str], crop_len: int, batch: int,
                 n_threads: int = 2, seed: int = 0, train: bool = True):
        lib = ctypes.CDLL(build_native())
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        # the C side copies the strings into its own vector while creating
        paths_arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.loader_create(paths_arr, len(paths), crop_len, batch,
                                         n_threads, seed, int(train))
        if not self._handle:
            raise RuntimeError("loader_create failed (no paths?)")
        self.batch = batch
        self.crop_len = crop_len

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise StopIteration
        out = np.empty((self.batch, self.crop_len), np.float32)
        rc = self._lib.loader_next(self._handle,
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def read_wav(path: str) -> np.ndarray:
    """Mono float32 samples of a RIFF/WAVE file: PCM16, PCM32 or IEEE
    float32, any channel count (the channels' mean). The sample rate is
    not read: a file's rate is the caller's convention."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt = 12, None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif tag == b"data" and fmt:
            code, ch, _, _, _, bits = fmt
            if code == 1 and bits == 16:
                x = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
            elif code == 1 and bits == 32:
                x = np.frombuffer(body, "<i4").astype(np.float32) / 2147483648.0
            elif code == 3 and bits == 32:
                x = np.frombuffer(body, "<f4").astype(np.float32)
            else:
                raise ValueError(f"{path}: unsupported wav format {fmt}")
            return x.reshape(-1, ch).mean(axis=1)
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


class NumpyAudioLoader:
    """The native loader's behaviour in numpy (its own random stream, so not
    its batches), for where no C++ compiler runs."""

    def __init__(self, paths: List[str], crop_len: int, batch: int,
                 seed: int = 0, train: bool = True, gain_db: tuple = (-6.0, -1.0)):
        self.paths = paths
        self.crop_len = crop_len
        self.batch = batch
        self.train = train
        self.gain_db = gain_db
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _read(path: str) -> np.ndarray:
        return read_wav(path)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.zeros((self.batch, self.crop_len), np.float32)
        for b in range(self.batch):
            x = self._read(self.paths[self.rng.integers(len(self.paths))])
            start = 0
            if self.train and len(x) > self.crop_len:
                start = int(self.rng.integers(0, len(x) - self.crop_len + 1))
            seg = x[start:start + self.crop_len]
            gain_db = self.rng.uniform(*self.gain_db)
            gain = 10 ** (gain_db / 20.0) / max(np.abs(x).max(), 1e-9)
            out[b, :len(seg)] = seg * gain
        return out


def make_audio_loader(paths: List[str], crop_len: int, batch: int, loader: str = "native",
                      **kw):
    """The native loader (``loader="native"``; raises if it does not build)
    or, when asked for, the numpy one (``loader="numpy"``)."""
    if loader == "native":
        return NativeAudioLoader(paths, crop_len, batch, **kw)
    if loader == "numpy":
        kw.pop("n_threads", None)
        return NumpyAudioLoader(paths, crop_len, batch, **kw)
    raise ValueError(f"unknown loader {loader!r} (native | numpy)")
