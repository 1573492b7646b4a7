"""Arithmetic (range) coding for neural-codec compression (PyTorch port).

The port's own copy of ``lina_speech_tpu/codec/ac.py`` (reference
encoder/quantization/ac.py, dead code in that snapshot): an integer
arithmetic coder that turns a model's per-symbol pdfs into a bitstream.
A pdf is first quantized to an integer cdf (:func:`build_stable_quantized_cdf`)
so that the encoder and the decoder derive the same table; the coder then
codes symbols against those cdfs. Coding is host work by nature
(sequential, data-dependent branching); the card's job is the pdfs
(``codec/lm.py``).

Two coders give the same bytes: the Python :class:`ArithmeticCoder` /
:class:`ArithmeticDecoder` and the native C++ pair
(``native/ac.cpp``, :class:`NativeArithmeticCoder` /
:class:`NativeArithmeticDecoder`). Both take one symbol a call (``push`` /
``pull``) or a step's symbols at once (``push_many`` / ``pull_many``).

One difference by design: :func:`make_coder` and :func:`make_decoder` take
the native coder and raise ``RuntimeError`` with the compiler's output when
it does not build; they give the Python coder only when the caller asks for
it (``native=False``), where the JAX package's fall back quietly and read an
environment variable. The library is built with ``g++`` at first use into
``build/ac/`` beside the package, under a name that carries a hash of the
source (as ``data/audio_loader.py`` builds the audio loader).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC_PATH = Path(__file__).resolve().parents[1] / "native" / "ac.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class BitPacker:
    """MSB-first bit writer."""

    def __init__(self):
        self._bytes = bytearray()
        self._cur = 0
        self._n = 0

    def push(self, bit: int):
        self._cur = (self._cur << 1) | (bit & 1)
        self._n += 1
        if self._n == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._n = 0

    def flush(self) -> bytes:
        if self._n:
            self._bytes.append(self._cur << (8 - self._n))
            self._cur = 0
            self._n = 0
        return bytes(self._bytes)


class BitUnpacker:
    """MSB-first bit reader; returns 0 past the end (decoder padding)."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def pull(self) -> int:
        byte, bit = divmod(self._pos, 8)
        self._pos += 1
        if byte >= len(self._data):
            return 0
        return (self._data[byte] >> (7 - bit)) & 1


def build_stable_quantized_cdf(pdf: np.ndarray, total_range_bits: int = 24,
                               roundoff: float = 1e-8) -> np.ndarray:
    """Float pdf -> integer cdf (int64, length n + 1, ``cdf[n] == 2**bits``).

    The pdf is first truncated to ``roundoff`` quanta, so pdfs that differ
    below that step give the same table; every symbol gets a count of at
    least 1, so every symbol stays decodable. Only pdfs that agree to the
    bit are sure to give the same table: a one-ulp difference moves a
    quantum boundary often enough that two devices' pdfs cannot be mixed
    (README.md, the port's section).
    """
    pdf = np.asarray(pdf, np.float64)
    if roundoff:
        pdf = np.floor(pdf / roundoff) * roundoff
    n = pdf.shape[-1]
    total = 1 << total_range_bits
    norm = pdf.sum()
    scaled = np.floor(pdf / max(norm, 1e-30) * (total - n)).astype(np.int64) + 1
    # the rounding drift goes to the largest bin (all counts stay >= 1)
    scaled[np.argmax(scaled)] += total - int(scaled.sum())
    cdf = np.zeros(n + 1, np.int64)
    np.cumsum(scaled, out=cdf[1:])
    return cdf


class ArithmeticCoder:
    """Integer arithmetic encoder over per-symbol quantized cdfs."""

    _P = 32  # internal precision; must exceed total_range_bits + 2

    def __init__(self):
        self._low = 0
        self._high = (1 << self._P) - 1
        self._pending = 0
        self._packer = BitPacker()

    def _emit(self, bit: int):
        self._packer.push(bit)
        while self._pending:
            self._packer.push(1 - bit)
            self._pending -= 1

    def push(self, symbol: int, cdf: np.ndarray):
        total = int(cdf[-1])
        span = self._high - self._low + 1
        self._high = self._low + span * int(cdf[symbol + 1]) // total - 1
        self._low = self._low + span * int(cdf[symbol]) // total
        half = 1 << (self._P - 1)
        quarter = 1 << (self._P - 2)
        while True:
            if self._high < half:
                self._emit(0)
            elif self._low >= half:
                self._emit(1)
                self._low -= half
                self._high -= half
            elif self._low >= quarter and self._high < 3 * quarter:
                self._pending += 1
                self._low -= quarter
                self._high -= quarter
            else:
                break
            self._low <<= 1
            self._high = (self._high << 1) | 1

    def push_many(self, symbols: np.ndarray, cdfs: np.ndarray):
        """symbols (m,), cdfs (m, n + 1): ``push`` of each in order."""
        for s, cdf in zip(np.asarray(symbols), cdfs):
            self.push(int(s), cdf)

    def flush(self) -> bytes:
        # one disambiguating interval bit + pending carries
        self._pending += 1
        self._emit(0 if self._low < (1 << (self._P - 2)) else 1)
        return self._packer.flush()


class ArithmeticDecoder:
    """Mirror of :class:`ArithmeticCoder`."""

    _P = ArithmeticCoder._P

    def __init__(self, data: bytes):
        self._low = 0
        self._high = (1 << self._P) - 1
        self._unpacker = BitUnpacker(data)
        self._value = 0
        for _ in range(self._P):
            self._value = (self._value << 1) | self._unpacker.pull()

    def pull(self, cdf: np.ndarray) -> int:
        total = int(cdf[-1])
        span = self._high - self._low + 1
        offset = ((self._value - self._low + 1) * total - 1) // span
        symbol = int(np.searchsorted(cdf, offset, side="right")) - 1
        self._high = self._low + span * int(cdf[symbol + 1]) // total - 1
        self._low = self._low + span * int(cdf[symbol]) // total
        half = 1 << (self._P - 1)
        quarter = 1 << (self._P - 2)
        while True:
            if self._high < half:
                pass
            elif self._low >= half:
                self._low -= half
                self._high -= half
                self._value -= half
            elif self._low >= quarter and self._high < 3 * quarter:
                self._low -= quarter
                self._high -= quarter
                self._value -= quarter
            else:
                break
            self._low <<= 1
            self._high = (self._high << 1) | 1
            self._value = (self._value << 1) | self._unpacker.pull()
        return symbol

    def pull_many(self, cdfs: np.ndarray) -> np.ndarray:
        """cdfs (m, n + 1) -> (m,) int32 symbols, ``pull`` of each in order."""
        return np.asarray([self.pull(cdf) for cdf in cdfs], np.int32)


# ------------------------------------------------------------ native coder
def build_dir() -> Path:
    """``build/ac`` beside the package (the repository root in a checkout)."""
    return SRC_PATH.parents[2] / "build" / "ac"


def build_native() -> str:
    """Compile the shared library unless one of the same source exists;
    returns its path. Raises ``RuntimeError`` with the compiler's output
    when ``g++`` is missing or fails."""
    digest = hashlib.sha256(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode())
    out = build_dir() / f"libac-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC_PATH), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native arithmetic coder: cannot run g++ ({e})") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native arithmetic coder: g++ failed:\n{e.stderr}") from e
    os.replace(tmp, out)  # atomic: concurrent builds each write their own tmp
    return str(out)


_LIB = None


def native_lib() -> ctypes.CDLL:
    """The native coder's library, built at first use and then reused."""
    global _LIB
    if _LIB is None:
        c = ctypes
        lib = c.CDLL(build_native())
        lib.ac_enc_create.restype = c.c_void_p
        lib.ac_enc_push.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int, c.c_int]
        lib.ac_enc_push_many.argtypes = [c.c_void_p, c.POINTER(c.c_int64),
                                         c.POINTER(c.c_int32), c.c_int, c.c_int]
        lib.ac_enc_flush_size.restype = c.c_int64
        lib.ac_enc_flush_size.argtypes = [c.c_void_p]
        lib.ac_enc_copy.argtypes = [c.c_void_p, c.POINTER(c.c_uint8)]
        lib.ac_enc_destroy.argtypes = [c.c_void_p]
        lib.ac_dec_create.restype = c.c_void_p
        lib.ac_dec_create.argtypes = [c.POINTER(c.c_uint8), c.c_int64]
        lib.ac_dec_pull.restype = c.c_int
        lib.ac_dec_pull.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int]
        lib.ac_dec_pull_many.argtypes = [c.c_void_p, c.POINTER(c.c_int64), c.c_int, c.c_int,
                                         c.POINTER(c.c_int32)]
        lib.ac_dec_destroy.argtypes = [c.c_void_p]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeArithmeticCoder:
    """The C++ encoder (``native/ac.cpp``), bit-identical to
    :class:`ArithmeticCoder`."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.ac_enc_create()

    def push(self, symbol: int, cdf: np.ndarray):
        cdf = np.ascontiguousarray(cdf, np.int64)
        self._lib.ac_enc_push(self._h, _ptr(cdf, ctypes.c_int64), len(cdf) - 1, int(symbol))

    def push_many(self, symbols: np.ndarray, cdfs: np.ndarray):
        """symbols (m,), cdfs (m, n + 1): one native call for a whole step."""
        cdfs = np.ascontiguousarray(cdfs, np.int64)
        syms = np.ascontiguousarray(symbols, np.int32)
        self._lib.ac_enc_push_many(self._h, _ptr(cdfs, ctypes.c_int64),
                                   _ptr(syms, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1] - 1)

    def flush(self) -> bytes:
        n = self._lib.ac_enc_flush_size(self._h)
        out = np.zeros(int(n), np.uint8)
        self._lib.ac_enc_copy(self._h, _ptr(out, ctypes.c_uint8))
        self._lib.ac_enc_destroy(self._h)
        self._h = None
        return out.tobytes()

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ac_enc_destroy(self._h)
            self._h = None


class NativeArithmeticDecoder:
    """The C++ decoder, bit-identical to :class:`ArithmeticDecoder`."""

    def __init__(self, lib: ctypes.CDLL, data: bytes):
        self._lib = lib
        buf = np.frombuffer(data, np.uint8)  # the C side copies it
        self._h = lib.ac_dec_create(_ptr(np.ascontiguousarray(buf), ctypes.c_uint8), len(data))

    def pull(self, cdf: np.ndarray) -> int:
        cdf = np.ascontiguousarray(cdf, np.int64)
        return int(self._lib.ac_dec_pull(self._h, _ptr(cdf, ctypes.c_int64), len(cdf) - 1))

    def pull_many(self, cdfs: np.ndarray) -> np.ndarray:
        cdfs = np.ascontiguousarray(cdfs, np.int64)
        out = np.zeros(cdfs.shape[0], np.int32)
        self._lib.ac_dec_pull_many(self._h, _ptr(cdfs, ctypes.c_int64), cdfs.shape[0],
                                   cdfs.shape[1] - 1, _ptr(out, ctypes.c_int32))
        return out

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ac_dec_destroy(self._h)
            self._h = None


def make_coder(native: bool = True):
    """A fresh encoder: the native one, or the Python one when
    ``native=False``. Raises ``RuntimeError`` when the native one does not
    build."""
    return NativeArithmeticCoder(native_lib()) if native else ArithmeticCoder()


def make_decoder(data: bytes, native: bool = True):
    """A decoder of ``data``: the native one, or the Python one when
    ``native=False``. Raises ``RuntimeError`` when the native one does not
    build."""
    return NativeArithmeticDecoder(native_lib(), data) if native else ArithmeticDecoder(data)
