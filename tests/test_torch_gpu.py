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


_GRAD_LEAVES = ("xq", "xk", "xv", "gk", "wq", "wk", "wv", "s0")


def _chunk_conv_grads(fn, x, with_s0, seed=3):
    """Gradients of sum(o * do) + sum(sf * dsf) through ``fn`` w.r.t. every
    input (random do and dsf from ``seed``)."""
    leaves = {n: x[n].detach().clone().requires_grad_(True)
              for n in _GRAD_LEAVES if with_s0 or n != "s0"}
    o, sf = fn(*(leaves[n] for n in _GRAD_LEAVES[:7]), initial_state=leaves.get("s0"))
    g = torch.Generator(device=o.device).manual_seed(seed)
    do = torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
    dsf = torch.randn(sf.shape, generator=g, device=o.device).to(sf.dtype)
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 151, 256, 512), (3, 2, 5, 64, 96), (1, 3, 3, 128, 32),
                                   (2, 2, 1, 64, 64), (1, 2, 70, 128, 64)])
def test_chunk_conv_backward_kernel_matches_plain_backward(cuda, io, st, shape):
    """All eight gradient leaves of the hand-written backward against
    autograd through the plain version, each within a share of its own
    max|plain|: 2e-3 for f32 IO (summation order), 2e-2 for bf16 IO (the
    gradients are rounded to bf16, and a bf16 pre-activation that rounds the
    other way moves silu' by an ulp). ``st=None``: no initial state."""
    b, h, t, dk, dv = shape
    x = _inputs(cuda, b, h, t, dk, dv, io, st or torch.float32, seed=t)
    before = gla_cuda.launch_counts()
    got = _chunk_conv_grads(gla_cuda.gla_chunk_conv, x, st is not None)
    after = gla_cuda.launch_counts()
    ref = _chunk_conv_grads(gla_cuda.gla_chunk_conv_plain, x, st is not None)
    torch.cuda.synchronize()
    assert after["gla_chunk_conv"] == before["gla_chunk_conv"] + 1
    assert after["gla_chunk_conv_bwd"] == before["gla_chunk_conv_bwd"] + 1
    tol = 2e-3 if io == torch.float32 else 2e-2
    for name, r in ref.items():
        a = got[name]
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        ref_max = float(r.float().abs().max())
        if name == "gk" and t == 1 and st is None:
            # one step from a zero state: the gate's gradient is zero, and the
            # kernel's is a difference of equal terms of dxq's size
            assert ref_max == 0
            ref_max = float(ref["xq"].float().abs().max())
        assert ref_max > 0, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * ref_max, (name, err, ref_max)


def test_chunk_conv_backward_skips_what_needs_no_gradient(cuda):
    """Only s0 requires grad (initial-state tuning): ds0 alone comes back and
    matches, and the wrappers note the shape and what was wanted; under
    no_grad the wrapper launches the forward only."""
    x = _inputs(cuda, 2, 2, 9, 64, 64, torch.float32, torch.float32)
    args = [x[n] for n in _GRAD_LEAVES[:7]]
    s0 = x["s0"].clone().requires_grad_(True)
    gla_cuda.reset_launch_counts()
    o, sf = gla_cuda.gla_chunk_conv(*args, initial_state=s0)
    (g,) = torch.autograd.grad((o ** 2).sum() + (sf ** 2).sum(), [s0])
    shapes = gla_cuda.launch_shapes()
    assert shapes["gla_chunk_conv"] == {(2, 9, torch.float32)}
    assert shapes["gla_chunk_conv_bwd"] == {(2, 9, torch.float32, True, False)}
    s0p = x["s0"].clone().requires_grad_(True)
    o, sf = gla_cuda.gla_chunk_conv_plain(*args, initial_state=s0p)
    (gp,) = torch.autograd.grad((o ** 2).sum() + (sf ** 2).sum(), [s0p])
    assert float((g - gp).abs().max()) <= 2e-3 * float(gp.abs().max())
    before = gla_cuda.launch_counts()
    with torch.no_grad():
        o, _ = gla_cuda.gla_chunk_conv(*args, initial_state=s0)
    assert o.grad_fn is None
    after = gla_cuda.launch_counts()
    assert after["gla_chunk_conv_bwd"] == before["gla_chunk_conv_bwd"]


def _chunk_grads(fn, x, with_s0, scale, seed=5):
    """o, sf and the gradients of sum(o * do) + sum(sf * dsf) through
    ``fn`` (gla_chunk or its plain version) w.r.t. q, k, v, gk (and s0)."""
    names = ("q", "k", "v", "gk") + (("s0",) if with_s0 else ())
    leaves = {n: x[n].detach().clone().requires_grad_(True) for n in names}
    o, sf = fn(leaves["q"], leaves["k"], leaves["v"], leaves["gk"],
               initial_state=leaves.get("s0"), scale=scale)
    g = torch.Generator(device=o.device).manual_seed(seed)
    do = torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
    dsf = torch.randn(sf.shape, generator=g, device=o.device).to(sf.dtype)
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    return o, sf, dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 70, 256, 256, None), (2, 32, 33, 64, 64, 1.0),
                                   (1, 2, 130, 128, 96, None)], ids=str)
def test_chunk_backward_kernel_matches_plain_backward(cuda, io, st, shape):
    """gla_chunk under autograd runs the forward kernel and the
    hand-written backward (one launch each), and every gradient (dq, dk, dv,
    dg, ds0) matches autograd through the plain version, each within a
    share of its own max|plain|: simple-GLA's head (dk 256, dv 256),
    Mamba-2's (dk 64, dv 64, scale 1.0) and a ragged one."""
    b, h, t, dk, dv, scale = shape
    x = _inputs(cuda, b, h, t, dk, dv, io, st or torch.float32, seed=7)
    x = dict(q=x["xq"], k=x["xk"], v=x["xv"], gk=x["gk"], s0=x["s0"])
    before = gla_cuda.launch_counts()
    o, sf, got = _chunk_grads(gla_cuda.gla_chunk, x, st is not None, scale)
    after = gla_cuda.launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_bwd"] == before["gla_chunk_bwd"] + 1
    o_p, sf_p, ref = _chunk_grads(gla_cuda.gla_chunk_plain, x, st is not None, scale)
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol and _rel_err(sf, sf_p) <= max(tol, 1e-2 * (st == torch.bfloat16))
    for name, r in ref.items():
        a = got[name]
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = float((a.float() - r.float()).abs().max())
        share = 2e-2 if io == torch.bfloat16 or st == torch.bfloat16 else 1e-3
        assert err <= share * float(r.float().abs().max()), (name, err)


def test_chunk_backward_notes_shapes_and_skips_ds0(cuda):
    """Only v requires grad: no ds0 is made, and launch_shapes notes the
    training forward and backward; under no_grad no backward is launched."""
    x = _inputs(cuda, 2, 2, 9, 64, 64, torch.float32, torch.float32)
    v = x["xv"].clone().requires_grad_(True)
    gla_cuda.reset_launch_counts()
    o, sf = gla_cuda.gla_chunk(x["xq"], x["xk"], v, x["gk"], initial_state=x["s0"])
    (g,) = torch.autograd.grad((o ** 2).sum() + (sf ** 2).sum(), [v])
    shapes = gla_cuda.launch_shapes()
    assert shapes["gla_chunk"] == {(2, 2, 9, 64, 64, torch.float32, torch.float32, 0.125)}
    assert shapes["gla_chunk_bwd"] == {(2, 2, 9, 64, 64, torch.float32, torch.float32, 0.125,
                                        False)}
    with torch.no_grad():
        o, _ = gla_cuda.gla_chunk(x["xq"], x["xk"], v, x["gk"])
    assert o.grad_fn is None and gla_cuda.launch_counts()["gla_chunk_bwd"] == 1


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 256, 256), (8, 4, 256, 256), (8, 32, 64, 64),
                                   (3, 2, 128, 96)], ids=str)
def test_decode_kernel_matches_plain(cuda, io, st, shape):
    """gla_decode (no convs) against gla_decode_plain: o and the state,
    updated in place, at simple-GLA's and Mamba-2's heads."""
    b, h, dk, dv = shape
    x = _inputs(cuda, b, h, 1, dk, dv, io, st)
    q, k, v, gk = (x[n][:, :, 0].contiguous() for n in ("xq", "xk", "xv", "gk"))
    s = x["s0"]
    o_p, s_p = gla_cuda.gla_decode_plain(q, k, v, gk, s)
    s_k = s.clone()
    o_k, s_out = gla_cuda.gla_decode(q, k, v, gk, s_k)
    assert s_out.data_ptr() == s_k.data_ptr()
    tol = 1e-4 if io == st == torch.float32 else 1e-2
    assert _rel_err(o_k, o_p) <= tol and _rel_err(s_out, s_p) <= tol


def _variant_cfg(**backbone):
    from lina_speech_tpu_torch.config import lina_gla_tiny

    cfg = lina_gla_tiny()
    return dataclasses.replace(cfg, d_model=256, backbone=dataclasses.replace(
        cfg.backbone, d_model=256, heads=4, **backbone),
        text_encoder=dataclasses.replace(cfg.text_encoder, dim=256))


def test_simple_gla_kernel_path_matches_plain_path(cuda):
    """Simple-GLA without convs at heads the kernels take (dk 64, dv 64), in
    f32: greedy tokens of the kernel path (gla_chunk for the prefill,
    gla_decode for every token) equal the plain path's, and the training
    forward's parameter gradients (gla_chunk's backward) match."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.train.harness import batch_to_device

    cfg = _variant_cfg(kind="simple_gla", use_short_conv=False)
    text = torch.randint(3, 256, (3, 9), generator=torch.Generator().manual_seed(0)).to(cuda)
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_codebook=50, min_audio_len=16, max_audio_len=24)), cuda)
    tokens, grads = {}, {}
    model = build_model(cfg, device=cuda, seed=3)
    n_layers = len(model.attentive_rnn.gla_layers())
    for mode in ("auto", "chunk"):
        model.set_kernel_mode(mode)
        gla_cuda.reset_launch_counts()
        res = generate_batch(model, text, max_seqlen=20, first_greedy_quant=0,
                             force_max_seqlen=True)
        model.zero_grad(set_to_none=True)
        model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
              batch["crossatt_mask"], logits_mask=batch["y_mask"])[1].backward()
        counts = gla_cuda.launch_counts()
        want = dict.fromkeys(counts, 0)
        if mode == "auto":
            want.update(gla_chunk=2 * n_layers, gla_decode=n_layers * 19, gla_chunk_bwd=n_layers)
        assert counts == want
        tokens[mode] = res.tokens.cpu()
        grads[mode] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert torch.equal(tokens["auto"], tokens["chunk"])
    for name, r in grads["chunk"].items():
        err = float((grads["auto"][name] - r).abs().max())
        assert err <= 1e-3 * float(r.abs().max()) + 1e-6, name


def test_tiny_config_trains_and_generates_on_the_card(cuda):
    """F1: lina_gla_tiny's heads (key dim 32) are not the kernels'; under
    kernel_mode="auto" every GLA layer routes to the plain versions before
    any launch (no kernel is launched), and a train step and a generate run
    on the card."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    model = build_model(lina_gla_tiny(), device=cuda)
    gla_cuda.reset_launch_counts()
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_codebook=50, min_audio_len=8, max_audio_len=16)), cuda)
    state = create_train_state(model, TrainConfig(n_warmup_steps=1, n_training_steps=4))
    state, metrics = make_train_step(model)(state, batch)
    res = generate_batch(model, batch["text_token"], max_seqlen=10, k=5,
                         generator=torch.Generator(device=cuda).manual_seed(0),
                         force_max_seqlen=True)
    assert torch.isfinite(metrics["loss"]) and res.tokens.shape == (1, 2, 10)
    assert gla_cuda.launch_counts() == dict.fromkeys(gla_cuda.launch_counts(), 0)


# ------------------------------------------------------ quantized serving
def _packed_weight(dev, n, k, seed):
    from lina_speech_tpu_torch.ops import qlinear
    from lina_speech_tpu_torch.utils.quantize import QKEY, SKEY, quantize_leaf

    g = torch.Generator(device=dev).manual_seed(seed)
    pair = quantize_leaf(torch.randn(n, k, generator=g, device=dev) * 0.05)
    return qlinear.pack_int8_weight(pair[QKEY]), pair[SKEY].reshape(-1), pair[QKEY]


@pytest.mark.parametrize("mode", ["wonly", "w8a8"])
@pytest.mark.parametrize("xdt,odt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 2048), (3, 85, 130), (8, 1365, 1024),
                                   (19, 341, 67), (64, 2048, 1024), (5, 4100, 40)])
def test_int8_linear_kernel_matches_plain(cuda, mode, xdt, odt, m, k, n):
    """K and N that are no multiples of 16 or 8, an m that is no multiple
    of the m-tile, a K longer than one staged pass."""
    from lina_speech_tpu_torch.ops import qlinear

    q, s, _ = _packed_weight(cuda, n, k, seed=k)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(2, m, k, generator=g, device=cuda).to(xdt)
    before = qlinear.int8_linear.launches
    out = qlinear.int8_linear(x, q, s, out_dtype=odt, mode=mode)
    ref = qlinear.int8_linear_plain(x, q, s, out_dtype=odt, mode=mode)
    torch.cuda.synchronize()
    assert qlinear.int8_linear.launches == before + 1
    assert out.shape == (2, m, n) and out.dtype == odt
    err = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    # w8a8 is an exact integer sum; wonly an f32 sum in another order
    tol = 2.0 ** -7 if odt == torch.bfloat16 else (1e-6 if mode == "w8a8" else 1e-4)
    assert ref_max > 0 and err <= tol * ref_max, (err, ref_max)


@pytest.mark.parametrize("xdt,odt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,d,hidden", [(1, 1024, 1365), (8, 1024, 1365), (3, 64, 85),
                                        (11, 256, 341), (1, 128, 512), (64, 1024, 1365)])
def test_fused_ffn_kernel_matches_plain(cuda, xdt, odt, bias, m, d, hidden):
    from lina_speech_tpu_torch.ops import qlinear

    q_in, s_in, _ = _packed_weight(cuda, 2 * hidden, d, seed=hidden)
    _, s_out, q_out = _packed_weight(cuda, d, hidden, seed=hidden + 1)
    q_out_t = q_out.T.contiguous()
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, d, generator=g, device=cuda).to(xdt)
    b_in = torch.randn(2 * hidden, generator=g, device=cuda) * 0.01 if bias else None
    b_out = torch.randn(d, generator=g, device=cuda) * 0.01 if bias else None
    args = (x, q_in, s_in, b_in, q_out_t, s_out, b_out)
    before = qlinear.fused_ffn_int8.launches
    out = qlinear.fused_ffn_int8(*args, out_dtype=odt)
    again = qlinear.fused_ffn_int8(*args, out_dtype=odt)
    ref = qlinear.fused_ffn_int8_plain(*args, out_dtype=odt)
    torch.cuda.synchronize()
    assert qlinear.fused_ffn_int8.launches == before + 2
    assert out.shape == (m, d) and out.dtype == odt
    assert torch.equal(out, again)  # fixed-order reduction: the same from run to run
    # a hidden unit whose bf16 rounding falls the other way moves the output
    # by a bf16 step of that unit: held to one bf16 step of the output's size
    err = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    assert ref_max > 0 and err <= 2.0 ** -7 * ref_max, (err, ref_max)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 256, 512, 16), (3, 3, 64, 128, 4), (1, 5, 128, 256, 16),
                                   (2, 2, 256, 512, 21)])
def test_int8_state_lazy_window_kernels_match_plain(cuda, io, shape):
    """A whole window over an int8 base state: every lazy step with
    ``s_scale`` and the requantizing fold against their plain versions."""
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    b, h, dk, dv, L = shape
    g = torch.Generator(device=cuda).manual_seed(L)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda)
    state_q, s_scale = quantize_state_rows(r(b, h, dk, dv) * 0.05)
    taps = [(r(4, h, d) * 0.5).to(io) for d in (dk, dk, dv)]
    k_rings = p_rings = [r(4, b, h, d).to(io) for d in (dk, dk, dv)]
    bufs = [(r(L, b, h, dk) * 9).to(io), (r(L, b, h, dv) * 9).to(io),
            torch.full((L, b, h, dk), 200.0, device=cuda), torch.zeros(b, h, dk, device=cuda)]
    k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
    tol = 1e-4 if io == torch.float32 else 1e-2
    for p in range(L):
        tok = (r(b, h, dk).to(io), r(b, h, dk).to(io), r(b, h, dv).to(io),
               torch.nn.functional.logsigmoid(r(b, h, dk)) / 4)
        before = gla_cuda.gla_decode_lazy_conv.q_launches
        out = gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, state_q, *k_bufs, p,
                                            s_scale=s_scale)
        ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, state_q, *p_bufs, p,
                                                  s_scale=s_scale)
        torch.cuda.synchronize()
        assert gla_cuda.gla_decode_lazy_conv.q_launches == before + 1
        assert out[0].dtype == io and _rel_err(out[0], ref[0]) <= tol
        assert _rel_err(out[7], ref[7]) <= 1e-6
        k_rings, k_bufs = out[1:4], list(out[4:8])
        p_rings, p_bufs = ref[1:4], list(ref[4:8])
    ref_q, ref_sc = gla_cuda.gla_fold_q_plain(state_q, s_scale, *p_bufs)
    q_in, sc_in = state_q.clone(), s_scale.clone()
    before = gla_cuda.gla_fold_q.launches
    new_q, new_sc = gla_cuda.gla_fold_q(q_in, sc_in, *k_bufs)
    torch.cuda.synchronize()
    assert gla_cuda.gla_fold_q.launches == before + 1
    assert new_q.data_ptr() == q_in.data_ptr() and new_sc.data_ptr() == sc_in.data_ptr()
    steps = (new_q.int() - ref_q.int()).abs()
    assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) < 0.02
    assert float(((new_sc - ref_sc).abs() / ref_sc).max()) <= 1e-5
    assert bool(new_q.any()) and not torch.equal(new_q, state_q)


def test_quantized_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from lina_speech_tpu_torch.ops import qlinear
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    q, s, raw = _packed_weight(cuda, 40, 85, seed=0)
    x = torch.randn(2, 85, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        qlinear.int8_linear(x, raw.contiguous(), s)  # unpadded rows
    with pytest.raises(ValueError, match="mode"):
        qlinear.int8_linear(x, q, s, mode="w4a4")
    with pytest.raises(ValueError, match="dtype"):
        qlinear.int8_linear(x.half(), q, s)
    with pytest.raises(ValueError, match="device"):
        qlinear.int8_linear(x, q.cpu(), s)
    state_q, sc = quantize_state_rows(torch.randn(1, 2, 64, 96, device=cuda))
    bufs = [torch.zeros(4, 1, 2, 64, device=cuda), torch.zeros(4, 1, 2, 96, device=cuda),
            torch.zeros(4, 1, 2, 64, device=cuda), torch.zeros(1, 2, 64, device=cuda)]
    with pytest.raises(ValueError, match="value dim"):
        gla_cuda.gla_fold_q(state_q, sc, *bufs)  # dv 96: no row-owning layout built
    with pytest.raises(ValueError, match="s_scale"):
        gla_cuda.gla_fold_q(state_q, None, *bufs)


def test_quantized_generate_kernel_path_matches_plain_path(cuda):
    """generate_batch with int8 weights and int8 lazy-window states on a
    small bf16 model: the kernel path's launches, and its teacher-forced
    logits against the plain path's."""
    from lina_speech_tpu_torch.config import BackboneConfig, ModelConfig, TextEncoderConfig
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.attentive_rnn import add_lazy_buffers
    from lina_speech_tpu_torch.models.base_blocks import use_int8_weights
    from lina_speech_tpu_torch.ops import qlinear

    cfg = ModelConfig(
        backbone=BackboneConfig(d_model=256, n_layer=2, heads=2, chunk_size=16,
                                state_dtype="bfloat16"),
        text_encoder=TextEncoderConfig(dim=256, heads=2, n_layers=1, dropout=0.0),
        d_model=256, n_codebook=50, compute_dtype="bfloat16")
    model = build_model(cfg, device=cuda, seed=3).eval()
    x = torch.randint(3, 256, (2, 6), device=cuda)
    gla_cuda.reset_launch_counts()
    qlinear.reset_launch_counts()
    res = generate_batch(model, x, max_seqlen=9, k=1, force_max_seqlen=True, lazy_window=4,
                         weight_quant="int8", quant_min_size=1 << 12, state_quant="int8")
    counts = {**gla_cuda.launch_counts(), **qlinear.launch_counts()}
    # 2 windows of 4 steps; 5 GLA layers, 4 of them with an int8 state
    assert counts["gla_decode_lazy_conv"] == 5 * 8 and counts["gla_fold_q"] == 4 * 2
    assert gla_cuda.gla_decode_lazy_conv.q_launches == 4 * 8 and counts["gla_fold"] == 2
    assert counts["fused_ffn_int8"] == 5 * 8 and counts["int8_linear"] > 0
    assert res.tokens.shape == (1, 2, 9)
    logits = {}
    with torch.no_grad(), use_int8_weights(model):
        x_enc = model.encode_text(x)
        y = model.embed_tokens(res.tokens[:, :, :5])
        for mode in ("auto", "chunk"):
            model.set_kernel_mode(mode)
            st = add_lazy_buffers(model.empty_state(2, device=cuda), 4, dtype=torch.bfloat16,
                                  state_quant="int8")
            out = []
            for p in range(4):
                lg, _, st = model.decode_step(y[:, p], x_enc, st, lazy_p=p)
                out.append(lg)
            st = model.fold_lazy_state(st)
            logits[mode] = torch.stack(out).float()
        model.set_kernel_mode("auto")
    assert bool(torch.isfinite(logits["auto"]).all())
    assert _rel_err(logits["auto"], logits["chunk"]) <= 5e-2


# ------------------------------------------------------------------ RWKV6
def _rwkv6_inputs(dev, b, h, t, dk, dv, io, st, seed=0):
    """r, k, v in ``io``; f32 log-decays spread as a trained RWKV6 layer's,
    with hard resets (-20); an f32 bonus; an initial state in ``st`` (None:
    none). The decode token takes time step 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r_ = lambda *s: torch.randn(*s, generator=g, device=dev)
    w = -torch.exp(r_(b, h, t, dk) * 0.5 - 2.0)
    w = torch.where(torch.rand(b, 1, t, 1, generator=g, device=dev) < 0.05, -20.0, w)
    return dict(r=r_(b, h, t, dk).to(io), k=r_(b, h, t, dk).to(io), v=r_(b, h, t, dv).to(io),
                w=w.contiguous(), u=r_(h, dk) * 0.5,
                s0=None if st is None else r_(b, h, dk, dv).to(st))


def _rwkv6_grads(fn, x, seed=3):
    """(o, sf, gradients) of sum(o * do) + sum(sf * dsf) through ``fn``
    (rwkv6_chunk or its plain version) w.r.t. r, k, v, w, u (and s0)."""
    names = ("r", "k", "v", "w", "u") + (("s0",) if x["s0"] is not None else ())
    leaves = {n: x[n].detach().clone().requires_grad_(True) for n in names}
    o, sf = fn(*(leaves[n] for n in names[:5]), initial_state=leaves.get("s0"))
    g = torch.Generator(device=o.device).manual_seed(seed)
    do = torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
    dsf = torch.randn(sf.shape, generator=g, device=o.device).to(sf.dtype)
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    return o, sf, dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 37, 256, 256), (1, 4, 1, 256, 256),
                                   (3, 2, 70, 64, 96)], ids=str)
def test_rwkv6_chunk_kernel_matches_plain(cuda, io, st, shape):
    """rwkv6_chunk (readout before the update, the u bonus, no scale) against
    its plain version: o and the final state, a ragged t and t = 1, with and
    without an initial state."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x = _rwkv6_inputs(cuda, *shape, io, st)
    args = (x["r"], x["k"], x["v"], x["w"], x["u"])
    before = rwkv6_cuda.rwkv6_chunk.launches
    o, s = rwkv6_cuda.rwkv6_chunk(*args, initial_state=x["s0"])
    o_p, s_p = rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])
    torch.cuda.synchronize()
    assert rwkv6_cuda.rwkv6_chunk.launches == before + 1
    assert o.dtype == io and s.dtype == (st or torch.float32)
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol
    assert _rel_err(s, s_p) <= (1e-2 if torch.bfloat16 in (io, st) else 1e-4)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 70, 256, 256), (1, 2, 130, 128, 96),
                                   (2, 2, 1, 64, 64)], ids=str)
def test_rwkv6_chunk_backward_kernel_matches_plain_backward(cuda, io, st, shape):
    """rwkv6_chunk under autograd runs the forward kernel and the
    hand-written backward (one launch each), and every gradient (dr, dk, dv,
    dw, du, ds0) matches autograd through the plain version, each within a
    share of its own max|plain|."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x = _rwkv6_inputs(cuda, *shape, io, st, seed=7)
    before = rwkv6_cuda.launch_counts()
    o, sf, got = _rwkv6_grads(rwkv6_cuda.rwkv6_chunk, x)
    after = rwkv6_cuda.launch_counts()
    assert after["rwkv6_chunk"] == before["rwkv6_chunk"] + 1
    assert after["rwkv6_chunk_bwd"] == before["rwkv6_chunk_bwd"] + 1
    o_p, sf_p, ref = _rwkv6_grads(rwkv6_cuda.rwkv6_chunk_plain, x)
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol
    assert _rel_err(sf, sf_p) <= (1e-2 if torch.bfloat16 in (io, st) else 1e-4)
    for name, r in ref.items():
        a = got[name]
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = float((a.float() - r.float()).abs().max())
        share = 2e-2 if torch.bfloat16 in (io, st) else 1e-3
        scale = float(r.float().abs().max())
        if name == "w" and shape[2] == 1 and st is None:
            # one token from a zero state: dw = dsf.S_final - k.(dsf v^T) is
            # 0 in exact arithmetic, two equal terms that cancel: held to
            # their size
            assert scale == 0
            scale = float((x["k"].float() * ref["k"].float()).abs().max())
        assert scale > 0 and err <= share * scale, (name, err)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 256, 256), (8, 4, 256, 256), (64, 4, 256, 256),
                                   (3, 2, 128, 96)], ids=str)
def test_rwkv6_decode_kernel_matches_plain(cuda, io, st, shape):
    """rwkv6_decode against its plain version: o and the state, updated in
    place, at every batch size (no tiny-batch routing)."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    b, h, dk, dv = shape
    x = _rwkv6_inputs(cuda, b, h, 1, dk, dv, io, st, seed=b)
    tok = tuple(x[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w"))
    o_p, s_p = rwkv6_cuda.rwkv6_decode_plain(*tok, x["u"], x["s0"])
    s_k = x["s0"].clone()
    o_k, s_out = rwkv6_cuda.rwkv6_decode(*tok, x["u"], s_k)
    torch.cuda.synchronize()
    assert s_out.data_ptr() == s_k.data_ptr() and s_out.dtype == st
    tol = 1e-4 if io == st == torch.float32 else 1e-2
    assert _rel_err(o_k, o_p) <= tol and _rel_err(s_out, s_p) <= tol


def test_rwkv6_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """kernel_takes refuses a head key dim outside (64, 128, 256) and an int8
    state, and a wrapper given such a head (or bf16 decays, or a bf16 bonus)
    raises instead of running the plain version; the plain route launches
    nothing."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    assert rwkv6_cuda.kernel_takes(256, 256, torch.bfloat16, torch.float32)
    assert not rwkv6_cuda.kernel_takes(32, 32, torch.float32, torch.float32)
    assert not rwkv6_cuda.kernel_takes(256, 256, torch.bfloat16, torch.int8)
    x = _rwkv6_inputs(cuda, 1, 2, 8, 64, 64, torch.bfloat16, torch.float32)
    args = [x["r"], x["k"], x["v"], x["w"], x["u"]]
    y = _rwkv6_inputs(cuda, 1, 2, 8, 32, 64, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError):  # a head the kernels do not take
        rwkv6_cuda.rwkv6_chunk(y["r"], y["k"], y["v"], y["w"], y["u"])
    with pytest.raises(ValueError):
        rwkv6_cuda.rwkv6_decode(*(y[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w")),
                                y["u"], y["s0"])
    with pytest.raises(ValueError):  # bf16 decays
        rwkv6_cuda.rwkv6_chunk(*args[:3], x["w"].bfloat16(), x["u"])
    with pytest.raises(ValueError):  # bf16 bonus
        rwkv6_cuda.rwkv6_chunk(*args[:4], x["u"].bfloat16())
    with pytest.raises(ValueError):  # state of another batch size
        rwkv6_cuda.rwkv6_chunk(*args, initial_state=torch.zeros(2, 2, 64, 64, device=cuda))
    rwkv6_cuda.reset_launch_counts()
    rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])
    rwkv6_cuda.rwkv6_decode_plain(*(a[:, :, 0].contiguous() for a in args[:4]), x["u"], x["s0"])
    assert rwkv6_cuda.launch_counts() == dict.fromkeys(rwkv6_cuda.launch_counts(), 0)


def test_rwkv6_kernel_path_matches_plain_path(cuda):
    """The RWKV6 backbone at heads the kernels take (d 256, 4 heads of dk 64,
    dv 64) in f32, with the bonus, the ddlerp mixes and the decays
    perturbed: greedy tokens of the kernel path (rwkv6_chunk for the
    prefill, rwkv6_decode for every token) equal the plain path's, and the
    training forward's parameter gradients (rwkv6_chunk's backward) match."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.rwkv6 import perturb_rwkv6_params_
    from lina_speech_tpu_torch.ops import rwkv6_cuda
    from lina_speech_tpu_torch.train.harness import batch_to_device

    cfg = _variant_cfg(kind="rwkv6")
    text = torch.randint(3, 256, (3, 9), generator=torch.Generator().manual_seed(0)).to(cuda)
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_codebook=50, min_audio_len=16, max_audio_len=24)), cuda)
    tokens, grads = {}, {}
    model = build_model(cfg, device=cuda, seed=3)
    perturb_rwkv6_params_(model, torch.Generator().manual_seed(4))
    n_layers = 2 * cfg.backbone.n_layer + 1
    for mode in ("auto", "chunk"):
        model.set_kernel_mode(mode)
        rwkv6_cuda.reset_launch_counts()
        res = generate_batch(model, text, max_seqlen=20, first_greedy_quant=0,
                             force_max_seqlen=True)
        model.zero_grad(set_to_none=True)
        model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
              batch["crossatt_mask"], logits_mask=batch["y_mask"])[1].backward()
        counts = rwkv6_cuda.launch_counts()
        want = dict.fromkeys(counts, 0)
        if mode == "auto":
            want.update(rwkv6_chunk=2 * n_layers, rwkv6_decode=n_layers * 19,
                        rwkv6_chunk_bwd=n_layers)
        assert counts == want
        tokens[mode] = res.tokens.cpu()
        grads[mode] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert torch.equal(tokens["auto"], tokens["chunk"])
    for name, r in grads["chunk"].items():
        err = float((grads["auto"][name] - r).abs().max())
        assert err <= 1e-3 * float(r.abs().max()) + 1e-6, name
