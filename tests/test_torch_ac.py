"""The port's arithmetic coder (``codec/ac.py``, ``native/ac.cpp``) against
the JAX package's, on the CPU.

Held exactly: the integer cdfs of ``build_stable_quantized_cdf`` on the same
pdfs (random, peaked, with zero bins, below the roundoff), and the bytes of
both of the port's coders against the JAX package's Python coder on the
same cdfs and symbols; round trips through every pairing of the port's
encoders and decoders; ``push_many`` / ``pull_many`` against loops of
``push`` / ``pull``. A failing compiler raises ``RuntimeError`` and no
environment variable picks a coder.
"""
import subprocess

import numpy as np
import pytest

from lina_speech_tpu.codec import ac as jax_ac
from lina_speech_tpu_torch.codec import ac


def _pdfs(kind, n, card, seed):
    rng = np.random.default_rng(seed)
    if kind == "dirichlet":
        return rng.dirichlet(np.full(card, 0.3), size=n)
    if kind == "peaked":  # one bin holds all but ~1e-9 of the mass
        p = rng.random((n, card)) * 1e-9
        p[np.arange(n), rng.integers(0, card, n)] = 1.0
        return p / p.sum(-1, keepdims=True)
    if kind == "zeros":  # most bins exactly zero
        p = rng.dirichlet(np.full(card, 0.5), size=n)
        p[rng.random((n, card)) < 0.7] = 0.0
        p[:, 0] += 1e-3
        return p / p.sum(-1, keepdims=True)
    if kind == "roundoff":  # bins below the 1e-8 quantum
        p = rng.random((n, card)) * 3e-8
        p[:, -1] = 1.0
        return p
    if kind == "softmax_f32":  # an LM's f32 softmax widened to f64
        z = rng.normal(size=(n, card)).astype(np.float32) * 3
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32).astype(np.float64)
    raise ValueError(kind)


def _symbols(pdfs, seed):
    rng = np.random.default_rng(seed + 100)
    return np.asarray([rng.choice(len(p), p=p / p.sum()) for p in pdfs])


@pytest.mark.parametrize("kind", ["dirichlet", "peaked", "zeros", "roundoff", "softmax_f32"])
@pytest.mark.parametrize("card", [17, 1024, 4096])
def test_cdf_equals_jax(kind, card):
    """Integer cdfs equal to JAX's, every count >= 1, the total 2**bits."""
    for bits in (24, 16):
        for p in _pdfs(kind, 4, card, card):
            got = ac.build_stable_quantized_cdf(p, bits)
            want = jax_ac.build_stable_quantized_cdf(p, bits)
            np.testing.assert_array_equal(got, want)
            assert got[-1] == 1 << bits and (np.diff(got) >= 1).all()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind,card", [("dirichlet", 100), ("peaked", 17), ("zeros", 47),
                                       ("softmax_f32", 1024)])
def test_bytes_equal_jax_python_coder(native, kind, card):
    """Both of the port's encoders give JAX's Python coder's bytes."""
    pdfs = _pdfs(kind, 300, card, 7)
    symbols = _symbols(pdfs, 7)
    cdfs = np.stack([ac.build_stable_quantized_cdf(p) for p in pdfs])
    ref = jax_ac.ArithmeticCoder()
    for s, c in zip(symbols, cdfs):
        ref.push(int(s), c)
    want = ref.flush()
    enc = ac.make_coder(native)
    assert isinstance(enc, ac.NativeArithmeticCoder if native else ac.ArithmeticCoder)
    for s, c in zip(symbols, cdfs):
        enc.push(int(s), c)
    assert enc.flush() == want


@pytest.mark.parametrize("enc_native", [True, False])
@pytest.mark.parametrize("dec_native", [True, False])
def test_round_trip(enc_native, dec_native):
    """Every pairing of the port's encoders and decoders returns the
    symbols, and JAX's Python decoder reads the port's stream."""
    pdfs = _pdfs("dirichlet", 500, 64, 3)
    symbols = _symbols(pdfs, 3)
    cdfs = np.stack([ac.build_stable_quantized_cdf(p) for p in pdfs])
    enc = ac.make_coder(enc_native)
    enc.push_many(symbols, cdfs)
    data = enc.flush()
    dec = ac.make_decoder(data, dec_native)
    np.testing.assert_array_equal([dec.pull(c) for c in cdfs], symbols)
    ref = jax_ac.ArithmeticDecoder(data)
    np.testing.assert_array_equal([ref.pull(c) for c in cdfs], symbols)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("k", [1, 8])
def test_push_many_equals_push_loop(native, k):
    """K symbols a step, as compress codes them, against one push each."""
    card, steps = 1024, 60
    pdfs = _pdfs("softmax_f32", steps * k, card, k).reshape(steps, k, card)
    symbols = _symbols(pdfs.reshape(-1, card), k).reshape(steps, k)
    cdfs = np.stack([[ac.build_stable_quantized_cdf(p) for p in row] for row in pdfs])
    many, loop = ac.make_coder(native), ac.make_coder(native)
    for t in range(steps):
        many.push_many(symbols[t], cdfs[t])
        for j in range(k):
            loop.push(int(symbols[t, j]), cdfs[t, j])
    data = many.flush()
    assert data == loop.flush()
    dec = ac.make_decoder(data, native)
    got = np.stack([dec.pull_many(cdfs[t]) for t in range(steps)])
    np.testing.assert_array_equal(got, symbols)


def test_native_decoder_reads_zeros_past_the_end():
    """An empty stream decodes as JAX's decoders decode it (zeros past the
    end), for the native and the Python decoder alike."""
    cdf = ac.build_stable_quantized_cdf(np.full(5, 0.2))
    want = jax_ac.ArithmeticDecoder(b"").pull(cdf)
    for native in (True, False):
        assert ac.make_decoder(b"", native).pull(cdf) == want


@pytest.mark.parametrize("failure", ["compiler_error", "no_compiler"])
def test_failed_build_raises(monkeypatch, tmp_path, failure):
    """A g++ that fails or is missing raises RuntimeError with its output;
    make_coder and make_decoder do not fall back to the Python coder."""
    def run(cmd, **kw):
        if failure == "no_compiler":
            raise FileNotFoundError(2, "No such file or directory", "g++")
        raise subprocess.CalledProcessError(1, cmd, output="", stderr="ac.cpp:1: error: boom")

    monkeypatch.setattr(ac, "_LIB", None)
    monkeypatch.setattr(ac, "build_dir", lambda: tmp_path / "ac")
    monkeypatch.setattr(ac.subprocess, "run", run)
    match = "boom" if failure == "compiler_error" else "cannot run g"
    for make in (ac.make_coder, lambda: ac.make_decoder(b"\x00")):
        with pytest.raises(RuntimeError, match=match):
            make()
    assert isinstance(ac.make_coder(native=False), ac.ArithmeticCoder)
    assert not list((tmp_path / "ac").glob("*.so"))


def test_no_environment_variable_selects_a_coder(monkeypatch):
    monkeypatch.setenv("LINA_NATIVE_AC", "0")
    assert isinstance(ac.make_coder(), ac.NativeArithmeticCoder)
    assert isinstance(ac.make_decoder(b""), ac.NativeArithmeticDecoder)


def test_build_is_reused_and_named_by_source():
    """The library lands in build/ac/ under the source's digest and a
    second build returns the same file."""
    path = ac.build_native()
    assert path == ac.build_native()
    assert path.startswith(str(ac.build_dir())) and "/libac-" in path
