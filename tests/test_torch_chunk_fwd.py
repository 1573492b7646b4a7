"""The chunked decomposition of the GLA forward, on the CPU.

``gla_chunk_conv_chunked_plain`` and ``gla_chunk_chunked_plain``
(ops/gla_cuda.py) are the chunked route of the CUDA forward written with
tensors: chunk states with the decayed key in two rounded parts, and the
intra-chunk scores with the 16-row sub-chunk factorisation, every product
operand rounded to the IO dtype. Here o and the final state are held
against the Pallas kernels in interpret mode (``gla_chunk_conv_pallas``,
``gla_chunk_pallas``) on the same inputs, made with numpy from a seed:
within 1e-4 of max(1, max|ref|) for f32 IO (summation order), and within
2e-2 of max|ref| for bf16 IO (both sides round their products' operands to
bf16, at other points: the Pallas kernel's dyadic levels and its one-part
decayed key).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.gla_pallas import gla_chunk_conv_pallas, gla_chunk_pallas
from lina_speech_tpu_torch.ops import gla_cuda

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 1e-4, BF16: 2e-2}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, t, io, st, b=2, h=2, dk=16, dv=32, adversarial=False):
    """q/xq, k/xk, v/xv and the taps in ``io``; f32 gates; an initial state
    of dtype ``st`` (None: none). Values are drawn in f32 and rounded to
    their dtype once, so both frameworks see the same numbers."""
    rng = np.random.default_rng(seed)
    gk = np.log(1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(b, h, t, dk)))))
    if adversarial:
        # every sixth key channel decays by 6 to 8 a step: a 64-row chunk's
        # gate sum there falls below -384, so e^{-bcum} would overflow f32
        gk[..., ::6] = -6.0 - 2.0 * rng.random(size=gk[..., ::6].shape)
    x = dict(q=rng.normal(size=(b, h, t, dk)), k=rng.normal(size=(b, h, t, dk)),
             v=rng.normal(size=(b, h, t, dv)), gk=gk,
             wq=rng.normal(size=(h * dk, 4)) * 0.5, wk=rng.normal(size=(h * dk, 4)) * 0.5,
             wv=rng.normal(size=(h * dv, 4)) * 0.5, s0=rng.normal(size=(b, h, dk, dv)))
    x = {n: torch.from_numpy(a.astype(np.float32)) for n, a in x.items()}
    for n in ("q", "k", "v", "wq", "wk", "wv"):
        x[n] = x[n].to(io)
    x["s0"] = None if st is None else x["s0"].to(st)
    return x


def _jax(a):
    """A torch tensor as a JAX array of the same dtype (None stays None)."""
    if a is None:
        return None
    j = jnp.asarray(a.float().numpy())
    return j.astype(jnp.bfloat16) if a.dtype == BF16 else j


def _hold(got, ref, io, name):
    o, sf = got
    jo, jsf = ref
    for what, a, r in (("o", o, jo), ("final state", sf, jsf)):
        r = np.asarray(r.astype(jnp.float32))
        a = a.float().numpy()
        assert a.shape == r.shape, (name, what)
        assert np.isfinite(a).all(), (name, what)
        ref_max = float(np.abs(r).max())
        assert ref_max > 0, (name, what)
        err = float(np.abs(a - r).max())
        limit = TOL[io] * (max(1.0, ref_max) if io == F32 else ref_max)
        assert err <= limit, (name, what, err, limit)


# (t, IO dtype, initial-state dtype or None, adversarial gates): every t of
# 1, 5, 64, 65 and 130 (ragged chunks and sub-chunks) in each IO dtype
# across the two functions, every initial state in each IO dtype
CONV_CASES = [(1, F32, None, False), (65, F32, F32, False), (130, F32, BF16, True),
              (5, BF16, BF16, False), (64, BF16, F32, False), (130, BF16, F32, True)]
CHUNK_CASES = [(5, F32, F32, False), (64, F32, None, False), (130, F32, BF16, True),
               (1, BF16, F32, False), (65, BF16, BF16, False), (130, BF16, None, True)]


@pytest.mark.parametrize("t,io,st,adversarial", CONV_CASES, ids=str)
def test_conv_chunked_forward_matches_pallas(t, io, st, adversarial):
    x = _inputs(10 + t, t, io, st, adversarial=adversarial)
    args = [x[n] for n in ("q", "k", "v", "gk", "wq", "wk", "wv")]
    got = gla_cuda.gla_chunk_conv_chunked_plain(*args, initial_state=x["s0"])
    assert got[0].dtype == io and got[1].dtype == (st or F32)
    ref = gla_chunk_conv_pallas(*map(_jax, args), initial_state=_jax(x["s0"]), chunk_size=64,
                                interpret=True)
    _hold(got, ref, io, "gla_chunk_conv")


@pytest.mark.parametrize("t,io,st,adversarial", CHUNK_CASES, ids=str)
def test_chunked_forward_matches_pallas(t, io, st, adversarial):
    x = _inputs(20 + t, t, io, st, adversarial=adversarial)
    args = [x[n] for n in ("q", "k", "v", "gk")]
    got = gla_cuda.gla_chunk_chunked_plain(*args, initial_state=x["s0"])
    assert got[0].dtype == io and got[1].dtype == (st or F32)
    ref = gla_chunk_pallas(*map(_jax, args), initial_state=_jax(x["s0"]), chunk_size=64,
                           interpret=True)
    _hold(got, ref, io, "gla_chunk")


@pytest.mark.parametrize("conv", [True, False])
def test_two_part_key_keeps_an_f32_final_state(conv):
    """bf16 IO with an f32 state over 320 steps: the decayed key enters the
    state update as two bf16 parts, so the final state stays within 1e-4 of
    max|S| of the f32 scan (gla_chunk_conv_plain / gla_chunk_plain), where
    one rounding of the key moves it by 2.5e-3 of max|S|; o, whose
    operands are rounded once, stays within 2e-2 of max|o|."""
    x = _inputs(3, 320, BF16, F32, dk=64, dv=64)
    args = [x[n] for n in ("q", "k", "v", "gk")] + (
        [x[n] for n in ("wq", "wk", "wv")] if conv else [])
    chunked = gla_cuda.gla_chunk_conv_chunked_plain if conv else gla_cuda.gla_chunk_chunked_plain
    plain = gla_cuda.gla_chunk_conv_plain if conv else gla_cuda.gla_chunk_plain
    o, sf = chunked(*args, initial_state=x["s0"])
    o_ref, sf_ref = plain(*args, initial_state=x["s0"])
    assert float((sf - sf_ref).abs().max()) <= 1e-4 * float(sf_ref.abs().max())
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2 * float(
        o_ref.float().abs().max())


@pytest.mark.parametrize("t", [1, 4, 16, 32, 63, 64, 127, 128, 151, 512])
@pytest.mark.parametrize("b,h,dv", [(1, 4, 512), (2, 4, 512), (8, 4, 512), (1, 32, 64),
                                    (1, 4, 256), (2, 4, 256), (8, 4, 256)])
def test_forward_plan_routes_by_io_dtype_and_length(b, h, dv, t):
    """f32 IO takes the recurrent body at every shape; bf16 IO the chunked
    route from the measured crossover on (64 tokens, but 128 above 8 heads
    in flight with dv below 512), the recurrent body below it."""
    assert gla_cuda.gla_chunk_fwd_plan(F32, b, h, t, dv) == "recurrent"
    want = "chunked" if t >= (128 if b * h > 8 and dv < 512 else 64) else "recurrent"
    assert gla_cuda.gla_chunk_fwd_plan(BF16, b, h, t, dv) == want


@pytest.mark.parametrize("b,t,dv,sms,want", [
    (8, 512, 512, 132, 1),   # the training forward: 256 blocks fill 132 SMs twice
    (8, 151, 512, 132, 2),   # generate's prefill: 96 blocks
    (1, 128, 512, 132, 8),   # the server's first chunk: 8 blocks, one a value tile
    (1, 64, 256, 132, 4),    # at most one group a 64-wide value tile
    (2, 512, 512, 132, 4),
    (8, 512, 512, 512, 4),   # a card with more SMs splits the same shape
])
def test_forward_output_split(b, t, dv, sms, want):
    """The output kernel's value-tile groups: as many as keep its blocks
    within two on each SM, at least one, at most one a value tile."""
    assert gla_cuda.fwd_out_split(b, 4, t, dv, sms) == want


@pytest.mark.parametrize("shape,sms,parts", [((8, 4, 512, 256, 512), 132, False),
                                             ((1, 4, 128, 256, 512), 132, True)])
def test_chunked_forward_scratch_bytes(shape, sms, parts):
    """The scratch one chunked call allocates: one buffer with a pointer for
    each of its ten arrays, each on a 256-byte boundary. At the flagship's
    training shape (b8 h4 t512 dk256 dv512) its bf16 chunk states are 67 MB
    of it and the output kernel forms the score matrices itself, so the key
    tiles' parts are not allocated (size 0, a null pointer); at the
    server's first chunk (b1 t128) they are, and the buffer is laid out
    here on the CPU."""
    split = gla_cuda.fwd_out_split(*shape[:3], shape[4], sms)
    sizes = gla_cuda._chunked_fwd_sizes(*shape, split)
    total = gla_cuda.chunked_fwd_scratch_bytes(*shape, sms)
    assert len(sizes) == 10 and (sizes[9] > 0) == parts == (split > 1)
    assert gla_cuda._scratch_total(sizes) == total and 0 <= total - sum(sizes) < 10 * 256
    if shape[0] == 8:
        assert sizes[6] == 8 * 4 * 8 * 256 * 512 * 2 == 67_108_864
        return
    buf, ptrs = gla_cuda._scratch(sizes, "cpu")
    offsets = [p.value - buf.data_ptr() for p in ptrs]
    assert buf.numel() == total and all(o % 256 == 0 for o in offsets)
    assert all(a + n <= b for a, n, b in zip(offsets, sizes, offsets[1:] + [total]))
