"""CUDA kernels of the PyTorch port vs their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device (decided in the
fixture, at run time). This file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Tolerances are relative to max(1, max|plain|): 1e-2 for bf16 outputs (one
bf16 ulp once summation order differs), 1e-4 for f32.
"""
import dataclasses

import pytest
import torch

from lina_speech_tpu_torch.ops import gla_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rel_err(a, ref):
    return float((a.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


def _inputs(dev, b, h, t, dk, dv, io, st, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    return dict(
        xq=r(b, h, t, dk).to(io), xk=r(b, h, t, dk).to(io), xv=r(b, h, t, dv).to(io),
        gk=torch.nn.functional.logsigmoid(r(b, h, t, dk)) / 4,
        wq=(r(h * dk, 4) * 0.5).to(io), wk=(r(h * dk, 4) * 0.5).to(io),
        wv=(r(h * dv, 4) * 0.5).to(io), s0=r(b, h, dk, dv).to(st))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 37, 256, 512), (3, 2, 70, 64, 96), (1, 3, 5, 128, 32)])
def test_chunk_conv_kernel_matches_plain(cuda, io, st, shape):
    b, h, t, dk, dv = shape
    x = _inputs(cuda, b, h, t, dk, dv, io, st)
    args = (x["xq"], x["xk"], x["xv"], x["gk"], x["wq"], x["wk"], x["wv"])
    before = gla_cuda.gla_chunk_conv.launches
    o, s = gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
    o_p, s_p = gla_cuda.gla_chunk_conv_plain(*args, initial_state=x["s0"])
    torch.cuda.synchronize()
    assert gla_cuda.gla_chunk_conv.launches == before + 1
    assert o.dtype == io and s.dtype == st
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol
    assert _rel_err(s, s_p) <= (1e-4 if io == st == torch.float32 else 1e-2)
    # zero initial state
    o0, _ = gla_cuda.gla_chunk_conv(*args)
    o0_p, _ = gla_cuda.gla_chunk_conv_plain(*args)
    assert _rel_err(o0, o0_p) <= tol


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
def test_decode_conv_kernel_matches_plain(cuda, io, st, b):
    h, dk, dv = 4, 256, 512
    x = _inputs(cuda, b, h, 1, dk, dv, io, st, seed=b)
    g = torch.Generator(device=cuda).manual_seed(9)
    rings = [torch.randn(4, b, h, d, generator=g, device=cuda).to(io) for d in (dk, dk, dv)]
    taps = [w.reshape(h, -1, 4).permute(2, 0, 1).contiguous() for w in (x["wq"], x["wk"], x["wv"])]
    args = (x["xq"][:, :, 0].contiguous(), x["xk"][:, :, 0].contiguous(),
            x["xv"][:, :, 0].contiguous(), x["gk"][:, :, 0].contiguous(), *taps, *rings)
    ref = gla_cuda.gla_decode_conv_plain(*args, x["s0"])
    state = x["s0"].clone()
    out = gla_cuda.gla_decode_conv(*args, state)
    torch.cuda.synchronize()
    assert out[1] is state  # updated in place
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(out[0], ref[0]) <= tol
    assert _rel_err(out[1], ref[1]) <= (1e-4 if io == st == torch.float32 else 1e-2)
    for a, r in zip(out[2:], ref[2:]):
        assert torch.equal(a, r)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 128, 256, 512), (3, 2, 70, 64, 96), (1, 3, 5, 128, 32),
                                   (2, 3, 1, 256, 64)])
def test_chunk_kernel_matches_plain(cuda, io, st, shape):
    b, h, t, dk, dv = shape
    x = _inputs(cuda, b, h, t, dk, dv, io, st)
    args = (x["xq"], x["xk"], x["xv"], x["gk"])
    before = gla_cuda.gla_chunk.launches
    o, s = gla_cuda.gla_chunk(*args, initial_state=x["s0"])
    o_p, s_p = gla_cuda.gla_chunk_plain(*args, initial_state=x["s0"])
    torch.cuda.synchronize()
    assert gla_cuda.gla_chunk.launches == before + 1
    assert o.dtype == io and s.dtype == st
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol
    assert _rel_err(s, s_p) <= (1e-4 if io == st == torch.float32 else 1e-2)
    o0, s0 = gla_cuda.gla_chunk(*args)
    o0_p, s0_p = gla_cuda.gla_chunk_plain(*args)
    assert s0.dtype == torch.float32
    assert _rel_err(o0, o0_p) <= tol and _rel_err(s0, s0_p) <= tol


def _lazy_inputs(dev, b, h, dk, dv, L, io, st, seed=0):
    """One token's inputs in the decode layout plus window buffers whose
    every slot holds garbage (a large positive cbuf would overflow an
    unclamped exp)."""
    x = _inputs(dev, b, h, 1, dk, dv, io, st, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    rings = [r(4, b, h, d).to(io) for d in (dk, dk, dv)]
    taps = [w.reshape(h, -1, 4).permute(2, 0, 1).contiguous() for w in (x["wq"], x["wk"], x["wv"])]
    tok = (x["xq"][:, :, 0].contiguous(), x["xk"][:, :, 0].contiguous(),
           x["xv"][:, :, 0].contiguous(), x["gk"][:, :, 0].contiguous())
    bufs = [(r(L, b, h, dk) * 9).to(io), (r(L, b, h, dv) * 9).to(io),
            torch.full((L, b, h, dk), 200.0, device=dev), torch.zeros(b, h, dk, device=dev)]
    return tok, taps, rings, x["s0"], bufs


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 256, 512, 16), (3, 3, 64, 96, 4), (1, 5, 128, 32, 16),
                                   (2, 2, 64, 64, 40)])
def test_lazy_window_kernels_match_plain_and_classic(cuda, io, st, shape):
    """A full window: every lazy step against its plain version (buffers in
    place, stale slots ignored), then the fold against its plain version
    and against the classic per-token recurrence."""
    b, h, dk, dv, L = shape
    tok, taps, rings, s0, bufs = _lazy_inputs(cuda, b, h, dk, dv, L, io, st)
    k_rings, p_rings, c_rings = list(rings), list(rings), list(rings)
    k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
    c_state = s0.clone()
    tol = 1e-4 if io == torch.float32 else 1e-2
    g = torch.Generator(device=cuda).manual_seed(5)
    before = gla_cuda.gla_decode_lazy_conv.launches
    for p in range(L):
        step = tuple((torch.randn(t.shape, generator=g, device=cuda) * (0.5 if t.dtype == io else 1))
                     .to(t.dtype) for t in tok[:3]) + (tok[3] * (1 + p % 3),)
        ptrs = [t.data_ptr() for t in k_bufs[:3]]
        out = gla_cuda.gla_decode_lazy_conv(*step, *taps, *k_rings, s0, *k_bufs, p)
        ref = gla_cuda.gla_decode_lazy_conv_plain(*step, *taps, *p_rings, s0, *p_bufs, p)
        cls = gla_cuda.gla_decode_conv_plain(*step, *taps, *c_rings, c_state)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in out[4:7]] == ptrs  # slot p written in place
        assert _rel_err(out[0], ref[0]) <= tol, p
        assert _rel_err(out[0], cls[0]) <= (1e-3 if io == st == torch.float32 else 3e-2), p
        for a, r_ in zip(out[1:4], ref[1:4]):
            assert torch.equal(a, r_)
        for a, r_ in zip(out[4:7], ref[4:7]):  # live slots only
            assert _rel_err(a[:p + 1], r_[:p + 1]) <= (1e-5 if io == torch.float32 else 1e-2)
        assert _rel_err(out[7], ref[7]) <= 1e-6
        k_rings, k_bufs = list(out[1:4]), list(out[4:8])
        p_rings, p_bufs = list(ref[1:4]), list(ref[4:8])
        c_state, c_rings = cls[1], list(cls[2:])
    assert gla_cuda.gla_decode_lazy_conv.launches == before + L
    ref_s = gla_cuda.gla_fold_plain(s0, *p_bufs)
    state = s0.clone()
    new_s = gla_cuda.gla_fold(state, *k_bufs)
    torch.cuda.synchronize()
    assert new_s is state and new_s.dtype == st
    tol_s = 1e-4 if io == st == torch.float32 else 1e-2
    assert _rel_err(new_s, ref_s) <= tol_s
    # the classic state was rounded to the state dtype at each of the L steps
    assert _rel_err(new_s, c_state) <= (1e-3 if io == st == torch.float32 else 5e-2)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _inputs(cuda, 1, 2, 8, 64, 64, torch.bfloat16, torch.bfloat16)
    args = [x["xq"], x["xk"], x["xv"], x["gk"], x["wq"], x["wk"], x["wv"]]
    with pytest.raises(ValueError):  # non-contiguous
        gla_cuda.gla_chunk_conv(x["xq"].transpose(2, 3).contiguous().transpose(2, 3),
                                *args[1:])
    with pytest.raises(ValueError):  # unsupported head dim
        y = _inputs(cuda, 1, 2, 8, 48, 64, torch.bfloat16, torch.bfloat16)
        gla_cuda.gla_chunk_conv(y["xq"], y["xk"], y["xv"], y["gk"], y["wq"], y["wk"], y["wv"])
    with pytest.raises(ValueError):  # bf16 gates
        gla_cuda.gla_chunk_conv(*args[:3], x["gk"].bfloat16(), *args[4:])
    with pytest.raises(ValueError):  # v in another dtype than q
        gla_cuda.gla_chunk(x["xq"], x["xk"], x["xv"].float(), x["gk"])
    with pytest.raises(ValueError):  # state of another batch size
        gla_cuda.gla_chunk(x["xq"], x["xk"], x["xv"], x["gk"],
                           initial_state=torch.zeros(2, 2, 64, 64, device=cuda))
    tok, taps, rings, s0, bufs = _lazy_inputs(cuda, 1, 2, 64, 64, 4, torch.bfloat16,
                                              torch.bfloat16)
    for p in (4, -1, torch.tensor(1)):  # outside the window, or not a host int
        with pytest.raises(ValueError):
            gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, s0, *bufs, p)
    with pytest.raises(ValueError):  # f32 window buffers beside bf16 IO
        gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, s0, bufs[0].float(), *bufs[1:], 0)
    with pytest.raises(ValueError):  # vbuf of another window length than kbuf
        gla_cuda.gla_decode_lazy_conv(*tok, *taps, *rings, s0, bufs[0], bufs[1][:2], *bufs[2:], 0)
    with pytest.raises(ValueError):  # cbuf not f32
        gla_cuda.gla_fold(s0, bufs[0], bufs[1], bufs[2].bfloat16(), bufs[3])
    with pytest.raises(ValueError):  # kbuf and vbuf of different dtypes
        gla_cuda.gla_fold(s0, bufs[0], bufs[1].float(), bufs[2], bufs[3])


def test_generate_kernel_path_matches_plain_path(cuda):
    """Greedy generation in f32 on a small model whose heads the kernels
    take (dk 64, dv 128): the kernel path and the plain path give the same
    tokens."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.generate import generate_batch

    cfg = lina_gla_tiny()
    cfg = dataclasses.replace(cfg, d_model=256, backbone=dataclasses.replace(
        cfg.backbone, d_model=256, heads=4, pos_type="convolutional"),
        text_encoder=dataclasses.replace(cfg.text_encoder, dim=256))
    text = torch.randint(3, 256, (3, 9), generator=torch.Generator().manual_seed(0)).to(cuda)
    prompt = torch.randint(0, 50, (1, 3, 12), generator=torch.Generator().manual_seed(1)).to(cuda)
    tokens = {}
    for mode in ("auto", "chunk"):
        model = build_model(dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, kernel_mode=mode)),
            device=cuda, seed=3)
        gla_cuda.reset_launch_counts()
        res = generate_batch(model, text, prompt=prompt, max_seqlen=30,
                             first_greedy_quant=0, force_max_seqlen=True)
        counts = gla_cuda.launch_counts()
        n_layers = len(model.attentive_rnn.gla_layers())
        if mode == "auto":
            assert counts == {**dict.fromkeys(counts, 0), "gla_chunk_conv": n_layers,
                              "gla_decode_conv": n_layers * (30 - 13)}
        else:
            assert counts == dict.fromkeys(counts, 0)
        tokens[mode] = res.tokens.cpu()
    assert torch.equal(tokens["auto"], tokens["chunk"])
