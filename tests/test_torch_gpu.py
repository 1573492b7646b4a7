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


def _fwd_call(conv, x, st, route=None, scale=None):
    """gla_chunk_conv (``conv``) or gla_chunk on ``x``, with its initial state
    where ``st`` is a dtype and none where it is None; ``route`` None for the
    public wrapper (the plan's route), "recurrent" or "chunked" for the
    wrapper's launcher forced onto that body, "chunked plain" for the
    chunked route's plain version and "plain" for the model's CPU path."""
    s0 = x["s0"] if st is not None else None
    args = [x["xq"], x["xk"], x["xv"], x["gk"]] + ([x["wq"], x["wk"], x["wv"]] if conv else [])
    fn = gla_cuda.gla_chunk_conv if conv else gla_cuda.gla_chunk
    if route == "plain":
        fn = gla_cuda.gla_chunk_conv_plain if conv else gla_cuda.gla_chunk_plain
    elif route == "chunked plain":
        fn = gla_cuda.gla_chunk_conv_chunked_plain if conv else gla_cuda.gla_chunk_chunked_plain
    elif route is not None:
        launch = gla_cuda._chunk_conv_launch if conv else gla_cuda._chunk_launch
        return launch(*args, s0, x["xq"].shape[-1] ** -0.5 if scale is None else scale, route)
    return fn(*args, initial_state=s0, scale=scale)


@pytest.mark.parametrize("conv", [True, False])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 37, 256, 512), (3, 2, 70, 64, 96), (1, 3, 5, 128, 32),
                                   (1, 4, 128, 256, 512), (2, 3, 1, 256, 64),
                                   (2, 4, 512, 256, 512), (2, 4, 130, 256, 512, "adversarial")],
                         ids=str)
def test_chunked_forward_matches_plain(cuda, conv, st, shape):
    """The chunked route (bf16 IO) against its plain version (the same
    decomposition with tensors) and against the model's plain path, at the
    shapes the forward kernels are held at above, t512 and gates that would
    overflow a whole-chunk factorisation: o within 1e-2 of max(1,
    max|plain|), the final state within 1e-3 in f32 (the decayed key enters
    the state update in two bf16 parts) and 1e-2 in bf16. Counted under its
    route."""
    b, h, t, dk, dv = shape[:5]
    x = _inputs(cuda, b, h, t, dk, dv, torch.bfloat16, st or torch.float32, seed=t + 2)
    if shape[5:] == ("adversarial",):
        x = _adversarial_gates(x)
    fn = gla_cuda.gla_chunk_conv if conv else gla_cuda.gla_chunk
    routes = dict(fn.routes)
    o, sf = _fwd_call(conv, x, st, route="chunked")
    torch.cuda.synchronize()
    routes["chunked"] += 1
    assert fn.routes == routes
    assert o.dtype == torch.bfloat16 and sf.dtype == (st or torch.float32)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(sf.float()).all())
    tol_s = 1e-2 if st == torch.bfloat16 else 1e-3
    for ref in ("chunked plain", "plain"):
        o_p, sf_p = _fwd_call(conv, x, st, route=ref)
        assert _rel_err(o, o_p) <= 1e-2, ref
        assert _rel_err(sf, sf_p) <= tol_s, ref


@pytest.mark.parametrize("conv", [True, False])
@pytest.mark.parametrize("st", [torch.bfloat16, None])
def test_chunked_forward_gives_equal_bits_on_a_second_call(cuda, conv, st):
    """The chunked forward sums in a fixed order (no atomics): a second call
    on the same inputs gives the same bits."""
    x = _inputs(cuda, 2, 4, 130, 256, 512, torch.bfloat16, st or torch.float32, seed=8)
    first = _fwd_call(conv, x, st, route="chunked")
    second = _fwd_call(conv, x, st, route="chunked")
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(first, second))


@pytest.mark.parametrize("conv", [True, False])
@pytest.mark.parametrize("io,t", [(torch.bfloat16, 151), (torch.bfloat16, 1),
                                  (torch.float32, 151)])
def test_forward_takes_the_planned_route(cuda, conv, io, t):
    """Without a route the wrappers take gla_chunk_fwd_plan's, count it under
    its name and note it with the shape; the chunked route refuses f32 IO."""
    fn = gla_cuda.gla_chunk_conv if conv else gla_cuda.gla_chunk
    x = _inputs(cuda, 1, 4, t, 256, 512, io, torch.float32)
    gla_cuda.reset_launch_counts()
    _fwd_call(conv, x, torch.float32)
    route = gla_cuda.gla_chunk_fwd_plan(io, 1, 4, t, 512)
    assert fn.routes == {"recurrent": 0, "chunked": 0, route: 1}
    assert all(shape[-1] == route for shape in gla_cuda.launch_shapes()[fn.__name__])
    if io == torch.float32:
        with pytest.raises(ValueError):
            _fwd_call(conv, x, torch.float32, route="chunked")


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
                                   (2, 2, 64, 64, 40), (64, 4, 256, 512, 16)])
def test_lazy_window_kernels_match_plain_and_classic(cuda, io, st, shape):
    """A full window: every lazy step against its plain version (buffers in
    place, stale slots ignored, equal bits on a second call), then the fold
    against its plain version and against the classic per-token
    recurrence."""
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
        kept = [t.clone() for t in out]
        again = gla_cuda.gla_decode_lazy_conv(*step, *taps, *k_rings, s0, *k_bufs, p)
        ref = gla_cuda.gla_decode_lazy_conv_plain(*step, *taps, *p_rings, s0, *p_bufs, p)
        cls = gla_cuda.gla_decode_conv_plain(*step, *taps, *c_rings, c_state)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in out[4:7]] == ptrs  # slot p written in place
        assert all(torch.equal(a, k) for a, k in zip(again, kept)), p  # equal bits
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
    assert gla_cuda.gla_decode_lazy_conv.launches == before + 2 * L
    ref_s = gla_cuda.gla_fold_plain(s0, *p_bufs)
    state = s0.clone()
    new_s = gla_cuda.gla_fold(state, *k_bufs)
    torch.cuda.synchronize()
    assert new_s is state and new_s.dtype == st
    tol_s = 1e-4 if io == st == torch.float32 else 1e-2
    assert _rel_err(new_s, ref_s) <= tol_s
    # the classic state was rounded to the state dtype at each of the L steps
    assert _rel_err(new_s, c_state) <= (1e-3 if io == st == torch.float32 else 5e-2)


@pytest.mark.parametrize("route,st", [("tile", "float32"), ("tile", "bfloat16"), ("tile", "int8"),
                                      ("cluster", "float32"), ("cluster", "bfloat16")])
@pytest.mark.parametrize("shape", [(1, 4, 256, 512, 16), (8, 4, 256, 512, 16),
                                   (64, 4, 256, 512, 16), (3, 3, 64, 128, 4),
                                   (2, 2, 128, 256, 21)])
def test_lazy_step_routes_match_plain(cuda, route, st, shape):
    """Both bodies of the lazy step, forced, over a whole window against
    the plain version (an int8 state on the tile route, its only body): o
    within 1e-2 of max(1, max|plain|) (bf16 IO), the rings, the live window
    slots and cc equal, slot p written in place, equal bits on a second
    call."""
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    b, h, dk, dv, L = shape
    io = torch.bfloat16
    tok, taps, rings, s0, bufs = _lazy_inputs(cuda, b, h, dk, dv, L, io, torch.float32, seed=L)
    s_scale = None
    if st == "int8":
        s0, s_scale = quantize_state_rows(s0 * 0.05)
    else:
        s0 = s0.to(getattr(torch, st))
    k_rings = p_rings = list(rings)
    k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
    g = torch.Generator(device=cuda).manual_seed(6)
    before = dict(gla_cuda.gla_decode_lazy_conv.routes)
    for p in range(L):
        step = tuple((torch.randn(t.shape, generator=g, device=cuda) * 0.5).to(t.dtype)
                     for t in tok[:3]) + (tok[3] * (1 + p % 3),)
        ptrs = [t.data_ptr() for t in k_bufs[:3]]
        call = lambda: gla_cuda._lazy_launch(*step, *taps, *k_rings, s0, *k_bufs, p,
                                             s_scale=s_scale, route=route)
        out = call()
        kept = [t.clone() for t in out]
        again = call()
        ref = gla_cuda.gla_decode_lazy_conv_plain(*step, *taps, *p_rings, s0, *p_bufs, p,
                                                  s_scale=s_scale)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in out[4:7]] == ptrs, p
        assert all(torch.equal(a, k) for a, k in zip(again, kept)), p
        assert bool(torch.isfinite(out[0].float()).all())
        assert _rel_err(out[0], ref[0]) <= 1e-2, p
        for a, r_ in zip(out[1:4], ref[1:4]):
            assert torch.equal(a, r_)
        for a, r_ in zip(out[4:7], ref[4:7]):
            assert torch.equal(a[:p + 1], r_[:p + 1]), p
        assert torch.equal(out[7], ref[7])
        k_rings, k_bufs = list(out[1:4]), list(out[4:8])
        p_rings, p_bufs = list(ref[1:4]), list(ref[4:8])
    assert gla_cuda.gla_decode_lazy_conv.routes[route] == before[route] + 2 * L


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
    off = torch.empty(s0.numel() + 1, dtype=s0.dtype, device=cuda)[1:].view(s0.shape)
    with pytest.raises(ValueError, match="16-byte"):  # a state the bulk copy cannot take
        gla_cuda._lazy_launch(*tok, *taps, *rings, off, *bufs, 0, route="cluster")
    with pytest.raises(ValueError, match="route"):
        gla_cuda._lazy_launch(*tok, *taps, *rings, s0, *bufs, 0, route="rows")
    # the cluster route has no int8 body (an int8 state it would take
    # otherwise: dv a multiple of 128, a 16-byte boundary)
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    q_tok, q_taps, q_rings, q_s0, q_bufs = _lazy_inputs(cuda, 1, 2, 64, 128, 4, torch.bfloat16,
                                                        torch.float32)
    q_state, s_scale = quantize_state_rows(q_s0)
    with pytest.raises(ValueError, match="no int8 state"):
        gla_cuda._lazy_launch(*q_tok, *q_taps, *q_rings, q_state, *q_bufs, 0, s_scale=s_scale,
                              route="cluster")
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


def _adversarial_gates(x):
    """Gates of -6 to -8 a step in every sixth key channel: a 64-row chunk's
    gate sum there is below -384, so e^{-bcum} would overflow f32."""
    g = torch.Generator(device=x["gk"].device).manual_seed(11)
    gk = x["gk"].clone()
    gk[..., ::6] = -6.0 - 2.0 * torch.rand(gk[..., ::6].shape, generator=g, device=gk.device)
    return dict(x, gk=gk)


# Lengths at and around the 64-row chunk's edges, and gates that would
# overflow a factorisation of the decay across a whole chunk.
_CHUNK_EDGE_SHAPES = [(2, 4, t, 256, 512) for t in (63, 64, 65, 128, 130)] + [
    (2, 4, 130, 256, 512, "adversarial")]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 151, 256, 512), (3, 2, 5, 64, 96), (1, 3, 3, 128, 32),
                                   (2, 2, 1, 64, 64), (1, 2, 70, 128, 64),
                                   *_CHUNK_EDGE_SHAPES])
def test_chunk_conv_backward_kernel_matches_plain_backward(cuda, io, st, shape):
    """All eight gradient leaves of the hand-written backward against
    autograd through the plain version, each within a share of its own
    max|plain|: 2e-3 for f32 IO (summation order), 2e-2 for bf16 IO (the
    gradients are rounded to bf16, the chunked route rounds its products'
    operands to bf16, and a bf16 pre-activation that rounds the other way
    moves silu' by an ulp). At the chunk-edge shapes under f32 IO, an
    element of a leaf stored in bf16 (ds0 of a bf16 state) past that bound
    must be the plain value's bf16 neighbour: two f32 values a hair apart may round one
    step apart, and a step is 2**-8 to 2**-7 of the value. ``st=None``: no
    initial state. bf16 IO takes the chunked route, f32 IO the recurrent
    one."""
    b, h, t, dk, dv = shape[:5]
    x = _inputs(cuda, b, h, t, dk, dv, io, st or torch.float32, seed=t)
    if shape[5:] == ("adversarial",):
        x = _adversarial_gates(x)
    before = gla_cuda.launch_counts()
    routes = dict(gla_cuda.gla_chunk_conv_bwd.routes)
    got = _chunk_conv_grads(gla_cuda.gla_chunk_conv, x, st is not None)
    after = gla_cuda.launch_counts()
    ref = _chunk_conv_grads(gla_cuda.gla_chunk_conv_plain, x, st is not None)
    torch.cuda.synchronize()
    assert after["gla_chunk_conv"] == before["gla_chunk_conv"] + 1
    assert after["gla_chunk_conv_bwd"] == before["gla_chunk_conv_bwd"] + 1
    route = "chunked" if io == torch.bfloat16 else "recurrent"
    routes[route] += 1
    assert gla_cuda.gla_chunk_conv_bwd.routes == routes
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
        err = (a.float() - r.float()).abs()
        over = err > tol * ref_max
        if io == torch.float32 and r.dtype == torch.bfloat16 and shape in _CHUNK_EDGE_SHAPES:
            steps = (a.view(torch.int16).int() - r.view(torch.int16).int()).abs()
            over &= steps > 1
        assert not bool(over.any()), (name, float(err.max()), ref_max)


def _bwd_args(x, st, seed=4):
    """The wrapper's arguments with random do and dsf; ``st`` None: no
    initial state (dsf then f32)."""
    g = torch.Generator(device=x["xq"].device).manual_seed(seed)
    do = torch.randn(x["xv"].shape, generator=g, device=x["xv"].device).to(x["xv"].dtype)
    dsf = torch.randn(x["s0"].shape, generator=g, device=x["xv"].device).to(st or torch.float32)
    return (*(x[n] for n in _GRAD_LEAVES[:7]), x["s0"] if st else None, do, dsf)


@pytest.mark.parametrize("st", [torch.bfloat16, None])
def test_chunked_backward_gives_equal_bits_on_a_second_call(cuda, st):
    """The chunked route sums in a fixed order (no atomics): a second call
    on the same inputs gives the same bits in every output."""
    x = _inputs(cuda, 2, 4, 130, 256, 512, torch.bfloat16, st or torch.float32, seed=8)
    args = _bwd_args(x, st)
    first = gla_cuda.gla_chunk_conv_bwd(*args)
    second = gla_cuda.gla_chunk_conv_bwd(*args)
    torch.cuda.synchronize()
    for name, a, r in zip(("dxq", "dxk", "dxv", "dg", "dwq", "dwk", "dwv", "ds0"), first, second):
        assert (a is None) == (r is None) == (name == "ds0" and st is None), name
        assert a is None or torch.equal(a, r), name


@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 130, 256, 512), (3, 2, 65, 64, 96), (1, 3, 17, 128, 32),
                                   (2, 4, 130, 256, 512, "adversarial")])
def test_chunked_backward_matches_its_plain_decomposition(cuda, st, shape):
    """The four chunked kernels and the finishing pass against
    gla_chunk_conv_bwd_chunked_plain, the same decomposition with tensors in
    f32 with the kernels' bf16 rounding points, on the same bf16 inputs:
    each output within 1e-2 of its own max|plain| (the outputs are rounded
    to bf16; f32 sums in another order and the card's exp move a rounded
    operand by an ulp now and then)."""
    b, h, t, dk, dv = shape[:5]
    x = _inputs(cuda, b, h, t, dk, dv, torch.bfloat16, st or torch.float32, seed=t + 1)
    if shape[5:] == ("adversarial",):
        x = _adversarial_gates(x)
    args = _bwd_args(x, st)
    got = gla_cuda.gla_chunk_conv_bwd(*args)
    ref = gla_cuda.gla_chunk_conv_bwd_chunked_plain(*args, operand_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    for name, a, r in zip(("dxq", "dxk", "dxv", "dg", "dwq", "dwk", "dwv", "ds0"), got, ref):
        if r is None:
            assert a is None and name == "ds0" and st is None
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        ref_max = float(r.float().abs().max())
        assert ref_max > 0, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * ref_max, (name, err, ref_max)


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
    assert shapes["gla_chunk_conv"] == {(2, 9, torch.float32, "recurrent")}
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
    hand-written backward (one launch each, on the route gla_chunk_bwd_plan
    gives: bf16 IO from 48 tokens chunked, else recurrent), and every
    gradient (dq, dk, dv, dg, ds0) matches autograd through the plain
    version, each within a share of its own max|plain|: simple-GLA's head
    (dk 256, dv 256), Mamba-2's (dk 64, dv 64, scale 1.0) and a ragged
    one."""
    b, h, t, dk, dv, scale = shape
    x = _inputs(cuda, b, h, t, dk, dv, io, st or torch.float32, seed=7)
    x = dict(q=x["xq"], k=x["xk"], v=x["xv"], gk=x["gk"], s0=x["s0"])
    before = gla_cuda.launch_counts()
    routes = dict(gla_cuda.gla_chunk_bwd.routes)
    o, sf, got = _chunk_grads(gla_cuda.gla_chunk, x, st is not None, scale)
    after = gla_cuda.launch_counts()
    assert after["gla_chunk"] == before["gla_chunk"] + 1
    assert after["gla_chunk_bwd"] == before["gla_chunk_bwd"] + 1
    routes[gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)] += 1
    assert gla_cuda.gla_chunk_bwd.routes == routes
    o_p, sf_p, ref = _chunk_grads(gla_cuda.gla_chunk_plain, x, st is not None, scale)
    tol = 1e-4 if io == torch.float32 else 1e-2
    assert _rel_err(o, o_p) <= tol and _rel_err(sf, sf_p) <= max(tol, 1e-2 * (st == torch.bfloat16))
    for name, r in ref.items():
        a = got[name]
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = float((a.float() - r.float()).abs().max())
        share = 2e-2 if io == torch.bfloat16 or st == torch.bfloat16 else 1e-3
        assert err <= share * float(r.float().abs().max()), (name, err)


_QKV_BWD_OUTS = ("dq", "dk", "dv", "dg", "ds0")


def _qkv_bwd_args(dev, shape, st, seed):
    """gla_chunk_bwd's arguments at ``shape`` = (b, h, t, dk, dv[, scale or
    "adversarial"]) in bf16 IO, random do and dsf; ``st`` None: no initial
    state (dsf then f32)."""
    b, h, t, dk, dv = shape[:5]
    x = _inputs(dev, b, h, t, dk, dv, torch.bfloat16, st or torch.float32, seed=seed)
    if shape[5:] == ("adversarial",):
        x = _adversarial_gates(x)
    scale = shape[5] if shape[5:] and shape[5] != "adversarial" else None
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(b, h, t, dv, generator=g, device=dev).to(torch.bfloat16)
    dsf = torch.randn(b, h, dk, dv, generator=g, device=dev).to(st or torch.float32)
    return (x["xq"], x["xk"], x["xv"], x["gk"], x["s0"] if st else None, do, dsf), scale


@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 130, 256, 256), (3, 2, 65, 64, 96), (1, 3, 17, 128, 32),
                                   (1, 2, 130, 128, 96), (2, 8, 70, 64, 64, 1.0),
                                   (2, 4, 130, 256, 256, "adversarial")], ids=str)
def test_chunked_chunk_backward_matches_its_plain_decomposition(cuda, st, shape):
    """gla_chunk_bwd's chunked route, forced at every length (the four
    chunked kernels without convs and the finishing pass) against
    gla_chunk_bwd_chunked_plain, the same
    decomposition with tensors in f32 with the kernels' bf16 rounding
    points, on the same bf16 inputs: each output within 1e-2 of its own
    max|plain| (the outputs are rounded to bf16; f32 sums in another order
    and the card's exp move a rounded operand by an ulp now and then). Every
    supported dk, a dv that is no multiple of 64, scale 1.0 and gates that
    would overflow a whole-chunk factorisation."""
    args, scale = _qkv_bwd_args(cuda, shape, st, seed=shape[2] + 2)
    routes = dict(gla_cuda.gla_chunk_bwd.routes)
    got = gla_cuda._chunk_bwd_launch(*args, scale, route="chunked")
    ref = gla_cuda.gla_chunk_bwd_chunked_plain(*args, scale, operand_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    routes["chunked"] += 1
    assert gla_cuda.gla_chunk_bwd.routes == routes
    for name, a, r in zip(_QKV_BWD_OUTS, got, ref):
        if r is None:
            assert a is None and name == "ds0" and st is None
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        ref_max = float(r.float().abs().max())
        assert ref_max > 0, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= 1e-2 * ref_max, (name, err, ref_max)


@pytest.mark.parametrize("st", [torch.bfloat16, None])
def test_chunked_chunk_backward_gives_equal_bits_on_a_second_call(cuda, st):
    """gla_chunk_bwd's chunked route sums in a fixed order (no atomics): a
    second call on the same inputs gives the same bits in every output."""
    args, _ = _qkv_bwd_args(cuda, (2, 4, 130, 256, 256), st, seed=8)
    first = gla_cuda.gla_chunk_bwd(*args)
    second = gla_cuda.gla_chunk_bwd(*args)
    torch.cuda.synchronize()
    for name, a, r in zip(_QKV_BWD_OUTS, first, second):
        assert (a is None) == (r is None) == (name == "ds0" and st is None), name
        assert a is None or torch.equal(a, r), name


@pytest.mark.parametrize("scale", [None, 1.0])
def test_chunked_chunk_backward_cancels_the_gate_gradient_of_one_step(cuda, scale):
    """One step from a zero state: the exact gate gradient is 0, and the
    chunked route's dg, a difference of terms of dq's and dk's size, cancels
    to f32 rounding (the dsf . S_final term is summed from the very f32
    values that enter dk), not to bf16 rounding."""
    args, _ = _qkv_bwd_args(cuda, (2, 4, 1, 256, 256), None, seed=13)
    dq, _, _, dg, _ = gla_cuda._chunk_bwd_launch(*args, scale, route="chunked")
    torch.cuda.synchronize()
    assert float(dg.abs().max()) <= 1e-5 * float(dq.float().abs().max())


def test_chunk_backward_forced_recurrent_route_launches_for_bf16(cuda):
    """The recurrent body of bf16 IO stays reachable when a route is forced
    (the card's route sweep), and matches the chunked route within a share
    of each output's own max; the public wrapper takes and counts the
    plan's route; a route that the IO dtype does not have raises."""
    args, _ = _qkv_bwd_args(cuda, (2, 4, 70, 256, 256), torch.float32, seed=12)
    gla_cuda.reset_launch_counts()
    rec = gla_cuda._chunk_bwd_launch(*args, route="recurrent")
    assert gla_cuda.gla_chunk_bwd.routes == {"recurrent": 1, "chunked": 0}
    got = gla_cuda.gla_chunk_bwd(*args)
    torch.cuda.synchronize()
    planned = gla_cuda.gla_chunk_bwd_plan(torch.bfloat16, 2, 4, 70, 256)
    assert planned == "chunked"
    assert gla_cuda.gla_chunk_bwd.routes == {"recurrent": 1, "chunked": 1}
    assert gla_cuda.launch_counts()["gla_chunk_bwd"] == 2
    for name, a, r in zip(_QKV_BWD_OUTS, got, rec):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 2e-2 * float(r.float().abs().max()), (name, err)
    f32 = tuple(a.float() if a is not None and a.dtype == torch.bfloat16 else a for a in args)
    with pytest.raises(ValueError, match="bf16 IO only"):
        gla_cuda._chunk_bwd_launch(*f32, route="chunked")


def test_chunk_backward_notes_shapes_and_skips_ds0(cuda):
    """Only v requires grad: no ds0 is made, and launch_shapes notes the
    training forward and backward; under no_grad no backward is launched."""
    x = _inputs(cuda, 2, 2, 9, 64, 64, torch.float32, torch.float32)
    v = x["xv"].clone().requires_grad_(True)
    gla_cuda.reset_launch_counts()
    o, sf = gla_cuda.gla_chunk(x["xq"], x["xk"], v, x["gk"], initial_state=x["s0"])
    (g,) = torch.autograd.grad((o ** 2).sum() + (sf ** 2).sum(), [v])
    shapes = gla_cuda.launch_shapes()
    assert shapes["gla_chunk"] == {(2, 2, 9, 64, 64, torch.float32, torch.float32, 0.125,
                                    "recurrent")}
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


# (kernel, (h, dk, dv), IO dtype): the flagship's conv step, simple-GLA's and
# Mamba-2's steps without convs, and a small odd head of each kernel
DECODE_HEADS = [("conv", (4, 256, 512), torch.bfloat16), ("noconv", (4, 256, 256), torch.bfloat16),
                ("noconv", (32, 64, 64), torch.float32), ("conv", (3, 64, 96), torch.float32),
                ("noconv", (3, 128, 96), torch.bfloat16)]


def _decode_step_args(dev, conv, b, h, dk, dv, io, st, seed):
    """A classic step's arguments but the state (the decode layouts), and
    the state."""
    x = _inputs(dev, b, h, 1, dk, dv, io, st, seed=seed)
    tok = tuple(x[n][:, :, 0].contiguous() for n in ("xq", "xk", "xv", "gk"))
    if not conv:
        return tok, x["s0"]
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    rings = [torch.randn(4, b, h, d, generator=g, device=dev).to(io) for d in (dk, dk, dv)]
    taps = [w.reshape(h, -1, 4).permute(2, 0, 1).contiguous() for w in (x["wq"], x["wk"], x["wv"])]
    return (*tok, *taps, *rings), x["s0"]


@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 8, 64])
@pytest.mark.parametrize("kernel,head,io", DECODE_HEADS, ids=str)
def test_decode_routes_match_split_plain(cuda, kernel, head, io, b, st):
    """Every body of the classic step, forced, against the plain version and
    each wide route also against its split plain version (its
    decomposition): o within 1e-2 of max(1, max|plain|) in bf16 IO, 1e-4 in
    f32; the state, updated in place, within one state-dtype rounding of
    the plain one (the kernels round e^g S + k v once, the plain version
    twice); the rings equal; equal bits on a second call; every route's
    state equal bit for bit (the same f32 expression, fma(e^g, S, k v), in
    every body)."""
    conv = kernel == "conv"
    h, dk, dv = head
    args, s0 = _decode_step_args(cuda, conv, b, h, dk, dv, io, st, seed=b + dk)
    plain = gla_cuda.gla_decode_conv_plain if conv else gla_cuda.gla_decode_plain
    split = gla_cuda.gla_decode_conv_split_plain if conv else gla_cuda.gla_decode_split_plain
    launch = gla_cuda._decode_conv_launch if conv else gla_cuda._decode_launch
    ref = plain(*args, s0)
    tol = 1e-4 if io == torch.float32 else 1e-2
    tol_s = 1e-5 if st == torch.float32 else 1e-2
    states = {}
    for route in gla_cuda._DECODE_ROUTE_CODE:
        s = s0.clone()
        out = launch(*args, s, route=route)
        s_again = s0.clone()
        again = launch(*args, s_again, route=route)
        torch.cuda.synchronize()
        assert out[1] is s, route  # updated in place
        assert bool(torch.isfinite(out[0].float()).all()), route
        assert _rel_err(out[0], ref[0]) <= tol, route
        assert _rel_err(out[1], ref[1]) <= tol_s, route
        if route != "tile":
            assert _rel_err(out[0], split(*args, s0, route=route)[0]) <= tol, route
        for a, r_ in zip(out[2:], ref[2:]):  # rings
            assert torch.equal(a, r_), route
        assert all(torch.equal(a, k) for a, k in zip(again, out)), route
        states[route] = s
    assert all(torch.equal(s, states["tile"]) for s in states.values())


def test_decode_wrappers_take_the_plan(cuda):
    """The public wrappers launch the route gla_decode_plan gives each shape
    (the tile body on a small state, a wide route on the flagship's at b1
    and b8), count it, note the shape with its route, and their routes sum
    to their launches."""
    gla_cuda.reset_launch_counts()
    want = []
    for b, h, dk, dv in ((1, 2, 64, 64), (1, 4, 256, 512), (8, 4, 256, 512)):
        for conv, fn in ((True, gla_cuda.gla_decode_conv), (False, gla_cuda.gla_decode)):
            args, s0 = _decode_step_args(cuda, conv, b, h, dk, dv, torch.bfloat16,
                                         torch.bfloat16, seed=b)
            fn(*args, s0)
            route = gla_cuda.gla_decode_plan(b, h, dk, dv, torch.bfloat16)
            want.append((fn, (b, h, dk, dv, torch.bfloat16, torch.bfloat16, route)))
    torch.cuda.synchronize()
    assert {route for _, (*_, route) in want} == {"tile", "wide4", "wide8"}
    for fn in (gla_cuda.gla_decode_conv, gla_cuda.gla_decode):
        assert fn.launches == 3 and sum(fn.routes.values()) == fn.launches
        shapes = {shape for f, shape in want if f is fn}
        assert gla_cuda.launch_shapes()[fn.__name__] == shapes
        assert fn.routes == {r: sum(1 for *_, rr in shapes if rr == r) for r in fn.routes}


def test_decode_wide_routes_refuse_what_they_cannot_take(cuda):
    """A state off a 16-byte boundary (the wide routes read and write it in
    16-byte words) and an unknown route raise before any launch."""
    args, s0 = _decode_step_args(cuda, False, 1, 2, 64, 64, torch.bfloat16, torch.bfloat16, 0)
    off = torch.empty(s0.numel() + 1, dtype=s0.dtype, device=cuda)[1:].view(s0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gla_cuda._decode_launch(*args, off, route="wide16")
    with pytest.raises(ValueError, match="route"):
        gla_cuda._decode_launch(*args, s0, route="rows")
    conv_args, _ = _decode_step_args(cuda, True, 1, 2, 64, 64, torch.bfloat16, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="16-byte"):
        gla_cuda._decode_conv_launch(*conv_args, off, route="wide4")
    out = gla_cuda._decode_launch(*args, off, route="tile")  # the tile body takes it
    torch.cuda.synchronize()
    assert out[1] is off


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
                                   (19, 341, 67), (64, 2048, 1024), (5, 4100, 40),
                                   (16, 1024, 2048), (64, 1024, 2048), (128, 1024, 2048),
                                   (67, 1365, 1024)])
def test_int8_linear_kernel_matches_plain(cuda, mode, xdt, odt, m, k, n):
    """K and N that are no multiples of 16, 32 or 8 (K 1365 splits unevenly
    across the stages of 64 columns and w8a8's k32 steps), an m that is no
    multiple of the m-tile, a K split across the most blocks of a cluster,
    m-tiles of 8 to 64 rows and two m-tiles. Two calls give equal bits;
    w8a8 equals its plain version bit for bit (an exact int32 sum, then the
    same two scale multiplications in the same order)."""
    from lina_speech_tpu_torch.ops import qlinear

    q, s, _ = _packed_weight(cuda, n, k, seed=k)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(2, m, k, generator=g, device=cuda).to(xdt)
    before = qlinear.int8_linear.launches
    out = qlinear.int8_linear(x, q, s, out_dtype=odt, mode=mode)
    again = qlinear.int8_linear(x, q, s, out_dtype=odt, mode=mode)
    ref = qlinear.int8_linear_plain(x, q, s, out_dtype=odt, mode=mode)
    torch.cuda.synchronize()
    assert qlinear.int8_linear.launches == before + 2
    assert out.shape == (2, m, n) and out.dtype == odt
    assert torch.equal(out, again)  # fixed-order sums: the same from run to run
    if mode == "w8a8":
        assert torch.equal(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    # w8a8 is an exact integer sum; wonly an f32 sum in another order
    tol = 2.0 ** -7 if odt == torch.bfloat16 else (1e-6 if mode == "w8a8" else 1e-4)
    assert ref_max > 0 and err <= tol * ref_max, (err, ref_max)


@pytest.mark.parametrize("xdt,odt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,d,hidden", [(1, 1024, 1365), (8, 1024, 1365), (3, 64, 85),
                                        (11, 256, 341), (1, 128, 512), (64, 1024, 1365),
                                        (16, 1024, 1365), (128, 1024, 1365), (67, 1024, 1365),
                                        (5, 2048, 2730)])
def test_fused_ffn_kernel_matches_plain(cuda, xdt, odt, bias, m, d, hidden):
    """Hidden widths that are no multiples of the 64-unit chunk, widths whose
    slices leave ranks of the cluster empty (d 64), m-tiles of 8 to 64 rows,
    two m-tiles, the widest model the kernel takes. q_out is the output
    Linear's packed (d, Hp) weight."""
    from lina_speech_tpu_torch.ops import qlinear

    q_in, s_in, _ = _packed_weight(cuda, 2 * hidden, d, seed=hidden)
    q_out, s_out, _ = _packed_weight(cuda, d, hidden, seed=hidden + 1)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, d, generator=g, device=cuda).to(xdt)
    b_in = torch.randn(2 * hidden, generator=g, device=cuda) * 0.01 if bias else None
    b_out = torch.randn(d, generator=g, device=cuda) * 0.01 if bias else None
    args = (x, q_in, s_in, b_in, q_out, s_out, b_out)
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


@pytest.mark.parametrize("m", [1, 64])
def test_fused_ffn_kernel_takes_bf16_biases(cuda, m):
    """Biases held in bf16 (the model's cast copies) are read as they are:
    the same result as the plain version's, and as the kernel's on the same
    biases in f32 bit for bit."""
    from lina_speech_tpu_torch.ops import qlinear

    d, hidden = 1024, 1365
    q_in, s_in, _ = _packed_weight(cuda, 2 * hidden, d, seed=5)
    q_out, s_out, _ = _packed_weight(cuda, d, hidden, seed=6)
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, d, generator=g, device=cuda).to(torch.bfloat16)
    b_in = (torch.randn(2 * hidden, generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    b_out = (torch.randn(d, generator=g, device=cuda) * 0.01).to(torch.bfloat16)
    out = qlinear.fused_ffn_int8(x, q_in, s_in, b_in, q_out, s_out, b_out)
    f32 = qlinear.fused_ffn_int8(x, q_in, s_in, b_in.float(), q_out, s_out, b_out.float())
    ref = qlinear.fused_ffn_int8_plain(x, q_in, s_in, b_in, q_out, s_out, b_out)
    torch.cuda.synchronize()
    assert torch.equal(out, f32)
    err = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    assert ref_max > 0 and err <= 2.0 ** -7 * ref_max, (err, ref_max)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 256, 512, 16), (3, 3, 64, 128, 4), (1, 5, 128, 256, 16),
                                   (2, 2, 256, 512, 21), (64, 4, 256, 512, 16)])
def test_int8_state_lazy_window_kernels_match_plain(cuda, io, shape):
    """A whole window over an int8 base state: every lazy step with
    ``s_scale`` (equal bits on a second call) and the requantizing fold
    against their plain versions."""
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
        kept = [t.clone() for t in out]
        again = gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, state_q, *k_bufs, p,
                                              s_scale=s_scale)
        ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, state_q, *p_bufs, p,
                                                  s_scale=s_scale)
        torch.cuda.synchronize()
        assert gla_cuda.gla_decode_lazy_conv.q_launches == before + 2
        assert all(torch.equal(a, k) for a, k in zip(again, kept)), p  # equal bits
        for a, r_ in zip(out[1:4], ref[1:4]):
            assert torch.equal(a, r_)
        for a, r_ in zip(out[4:7], ref[4:7]):  # live slots only
            assert _rel_err(a[:p + 1], r_[:p + 1]) <= (1e-5 if io == torch.float32 else 1e-2)
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


def _fold_case(dev, b, h, dk, dv, L, io, st, seed=0):
    """A full window as a main path leaves it (cumsums of log-gates in cbuf,
    cc the last) and a state; an int8 state with its row scales."""
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    cums = (torch.nn.functional.logsigmoid(r(L, b, h, dk)) / 16).cumsum(0)
    bufs = [(r(L, b, h, dk) * 9).to(io), (r(L, b, h, dv) * 3).to(io), cums.contiguous(),
            cums[-1].clone()]
    if st == torch.int8:
        return (*quantize_state_rows(r(b, h, dk, dv) * 0.05), bufs)
    return r(b, h, dk, dv).to(st), None, bufs


# (b, h, dk, dv, L): dk 64/128/256, dv 32, 96 and 512, windows of 1, 16 and
# 40 slots (40: staged in one go or in passes), b 1, 8 and 64
FOLD_SHAPES = [(1, 4, 256, 512, 16), (8, 4, 256, 512, 16), (64, 4, 256, 512, 16),
               (3, 3, 64, 96, 1), (2, 5, 128, 96, 40), (2, 2, 256, 96, 16),
               (1, 5, 128, 32, 16), (8, 2, 256, 32, 40), (2, 2, 256, 512, 40)]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_fold_kernel_matches_plain_on_every_band(cuda, io, st, shape):
    """gla_fold on every band height the head takes: against its plain
    version (1e-4 of max(1, max|plain|) for f32 IO and state, else 1e-2) and
    against the plain mirror of its bf16-part decomposition (a state
    rounding step), in place, equal bits on a second call."""
    b, h, dk, dv, L = shape
    s0, _, bufs = _fold_case(cuda, b, h, dk, dv, L, io, st, seed=L)
    ref = gla_cuda.gla_fold_plain(s0, *bufs)
    mirror = gla_cuda.gla_fold_parts_plain(s0, *bufs)
    tol = 1e-4 if io == st == torch.float32 else 1e-2
    heights = gla_cuda.fold_band_heights(dk, dv, st)
    assert int(gla_cuda.gla_fold_plan(b, h, dk, dv, st)[4:]) in heights
    for r in heights:
        state = s0.clone()
        out = gla_cuda._fold_launch(state, *bufs, route=f"band{r}")
        again = gla_cuda._fold_launch(s0.clone(), *bufs, route=f"band{r}")
        torch.cuda.synchronize()
        assert out is state and out.dtype == st, r
        assert torch.equal(out, again), r
        assert bool(torch.isfinite(out.float()).all()), r
        assert _rel_err(out, ref) <= tol, (r, _rel_err(out, ref))
        assert _rel_err(out, mirror) <= (1e-5 if st == torch.float32 else 1e-2), r
    before = gla_cuda.gla_fold.launches
    planned = gla_cuda.gla_fold(s0.clone(), *bufs)
    assert gla_cuda.gla_fold.launches == before + 1 and _rel_err(planned, ref) <= tol


# (b, h, dk, dv, L): dk 64/128/256, dv 128, 256 and 512, L 1, 16 and 40, b 1, 8, 64
FOLD_Q_SHAPES = [(1, 4, 256, 512, 16), (8, 4, 256, 512, 16), (64, 4, 256, 512, 16),
                 (3, 3, 64, 128, 1), (2, 5, 128, 256, 40), (8, 2, 256, 512, 40),
                 (2, 3, 128, 128, 16)]


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FOLD_Q_SHAPES)
def test_fold_q_kernel_matches_plain_on_every_band(cuda, io, shape):
    """gla_fold_q on every band height: the int8 state at most one integer
    step from the plain version and from the plain mirror of its
    decomposition with at most 1e-3 of the elements differing, the scales
    to 1e-5 of each, in place, equal bits on a second call."""
    b, h, dk, dv, L = shape
    q0, sc0, bufs = _fold_case(cuda, b, h, dk, dv, L, io, torch.int8, seed=L + 1)
    refs = [gla_cuda.gla_fold_q_plain(q0, sc0, *bufs),
            gla_cuda.gla_fold_q_parts_plain(q0, sc0, *bufs)]
    for r in gla_cuda.fold_band_heights(dk, dv, torch.int8):
        q, sc = q0.clone(), sc0.clone()
        out = gla_cuda._fold_q_launch(q, sc, *bufs, route=f"band{r}")
        again = gla_cuda._fold_q_launch(q0.clone(), sc0.clone(), *bufs, route=f"band{r}")
        torch.cuda.synchronize()
        assert out[0] is q and out[1] is sc and q.dtype == torch.int8, r
        assert torch.equal(q, again[0]) and torch.equal(sc, again[1]), r
        assert not torch.equal(q, q0), r
        for rq, rsc in refs:
            steps = (q.int() - rq.int()).abs()
            assert int(steps.max()) <= 1 and float((steps > 0).float().mean()) <= 1e-3, r
            assert float(((sc - rsc).abs() / rsc).max()) <= 1e-5, r


def test_fold_q_requantizes_by_the_true_division(cuda):
    """With no keys in the window and cc 0 the fold only requantizes the
    int8 state: S = s S_q in f32, sc = max / 127, round(S / sc), both
    divisions true ones, the second from sc's reciprocal in the kernel. Its
    integers and scales equal the plain version's on the CPU (where PyTorch
    divides by 127 truly; on the card it multiplies by 1 / 127) bit for bit,
    on every band."""
    b, h, dk, dv, L = 8, 4, 256, 512, 16
    q0, sc0, bufs = _fold_case(cuda, b, h, dk, dv, L, torch.bfloat16, torch.int8, seed=9)
    g = torch.Generator(device=cuda).manual_seed(3)
    bufs[0] = torch.zeros_like(bufs[0])
    bufs[3] = torch.zeros_like(bufs[3])
    sc0 = sc0 * torch.exp(torch.randn(b, h, dk, generator=g, device=cuda) * 4)  # rows of all sizes
    rq, rsc = gla_cuda.gla_fold_q_plain(q0.cpu(), sc0.cpu(), *(t.cpu() for t in bufs))
    for r in gla_cuda.fold_band_heights(dk, dv, torch.int8):
        q, sc = gla_cuda._fold_q_launch(q0.clone(), sc0.clone(), *bufs, route=f"band{r}")
        torch.cuda.synchronize()
        assert torch.equal(q.cpu(), rq), (r, int((q.cpu() != rq).sum()))
        assert torch.equal(sc.cpu(), rsc), (r, int((sc.cpu() != rsc).sum()))


def test_folds_refuse_what_they_do_not_take(cuda):
    """A band off the head's heights, a state or vbuf off a 16-byte
    boundary, an int8 fold of dv 96: each raises before any launch."""
    s0, _, bufs = _fold_case(cuda, 2, 2, 64, 64, 16, torch.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError, match="route"):
        gla_cuda._fold_launch(s0, *bufs, route="tile")
    with pytest.raises(ValueError, match="route"):
        gla_cuda._fold_launch(s0, *bufs, route="band128")  # dk 64 has no 128-row band
    off = torch.empty(s0.numel() + 1, dtype=s0.dtype, device=cuda)[1:].view(s0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gla_cuda.gla_fold(off, *bufs)
    voff = torch.empty(bufs[1].numel() + 1, dtype=bufs[1].dtype, device=cuda)[1:].view(
        bufs[1].shape)
    with pytest.raises(ValueError, match="16-byte"):
        gla_cuda.gla_fold(s0, bufs[0], voff, *bufs[2:])
    q0, sc0, qbufs = _fold_case(cuda, 2, 2, 64, 128, 16, torch.bfloat16, torch.int8)
    with pytest.raises(ValueError, match="route"):
        gla_cuda._fold_q_launch(q0, sc0, *qbufs, route="rows")
    qoff = torch.empty(q0.numel() + 1, dtype=q0.dtype, device=cuda)[1:].view(q0.shape)
    with pytest.raises(ValueError, match="16-byte"):
        gla_cuda.gla_fold_q(qoff, sc0, *qbufs)


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


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 256, 256), (8, 4, 256, 256), (64, 4, 256, 256),
                                   (3, 2, 128, 96)], ids=str)
def test_rwkv6_decode_routes_match_plain(cuda, io, st, shape):
    """Every body of rwkv6_decode (the classic step's template in its RWKV6
    mode), forced, against the plain version: o within 1e-2 of max(1,
    max|plain|) in bf16 IO, 1e-4 in f32; the state, updated in place, within
    one state-dtype rounding of the plain one (the kernel rounds fma(e^w, S,
    k v) once, the plain version twice); equal bits on a second call; every
    route's state equal bit for bit; each call one launch, counted under
    its route."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    b, h, dk, dv = shape
    x = _rwkv6_inputs(cuda, b, h, 1, dk, dv, io, st, seed=b + dk)
    tok = tuple(x[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w"))
    o_p, s_p = rwkv6_cuda.rwkv6_decode_plain(*tok, x["u"], x["s0"])
    tol = 1e-4 if io == torch.float32 else 1e-2
    tol_s = 1e-5 if st == torch.float32 else 1e-2
    rwkv6_cuda.reset_launch_counts()
    states = {}
    for route in rwkv6_cuda._DECODE_ROUTE_CODE:
        s = x["s0"].clone()
        o, s_out = rwkv6_cuda._decode_launch(*tok, x["u"], s, route=route)
        again = rwkv6_cuda._decode_launch(*tok, x["u"], x["s0"].clone(), route=route)
        torch.cuda.synchronize()
        assert s_out is s and s.dtype == st, route
        assert bool(torch.isfinite(o.float()).all()), route
        assert _rel_err(o, o_p) <= tol and _rel_err(s, s_p) <= tol_s, route
        assert torch.equal(again[0], o) and torch.equal(again[1], s), route
        states[route] = s
    assert all(torch.equal(s, states["tile"]) for s in states.values())
    n = len(rwkv6_cuda._DECODE_ROUTE_CODE)
    assert rwkv6_cuda.launch_counts()["rwkv6_decode"] == 2 * n
    assert rwkv6_cuda.rwkv6_decode.routes == dict.fromkeys(rwkv6_cuda._DECODE_ROUTE_CODE, 2)


def test_rwkv6_decode_takes_the_plan(cuda):
    """The public wrapper launches the route rwkv6_decode_plan gives each
    shape (the tile body on a 512 KiB state, wide routes above), one launch
    a call, counted under its route and noted with the shape and route."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    rwkv6_cuda.reset_launch_counts()
    want = {}
    for b, st in ((1, torch.bfloat16), (1, torch.float32), (8, torch.float32),
                  (64, torch.bfloat16)):
        x = _rwkv6_inputs(cuda, b, 4, 1, 256, 256, torch.bfloat16, st, seed=b)
        tok = tuple(x[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w"))
        rwkv6_cuda.rwkv6_decode(*tok, x["u"], x["s0"])
        route = rwkv6_cuda.rwkv6_decode_plan(b, 4, 256, 256, st)
        want[(b, 4, 256, 256, torch.bfloat16, st, route)] = 1
    torch.cuda.synchronize()
    assert [k[-1] for k in want] == ["tile", "wide4", "wide8", "wide16"]
    assert rwkv6_cuda.launch_counts()["rwkv6_decode"] == 4
    assert rwkv6_cuda.launch_shape_counts()["rwkv6_decode"] == want
    assert rwkv6_cuda.rwkv6_decode.routes == {"tile": 1, "wide4": 1, "wide8": 1, "wide16": 1}


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


def _rwkv6_fwd_call(x, route=None):
    """rwkv6_chunk on ``x``: ``route`` None for the public wrapper (the
    plan's route), "recurrent" or "chunked" for the wrapper's launcher forced
    onto that body, "chunked plain" for the chunked route's plain version and
    "plain" for the model's CPU path."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    args = (x["r"], x["k"], x["v"], x["w"], x["u"])
    if route in ("recurrent", "chunked"):
        return rwkv6_cuda._chunk_launch(*args, x["s0"], route=route)
    fn = {None: rwkv6_cuda.rwkv6_chunk, "plain": rwkv6_cuda.rwkv6_chunk_plain,
          "chunked plain": rwkv6_cuda.rwkv6_chunk_chunked_plain}[route]
    return fn(*args, initial_state=x["s0"])


def _own_max_err(a, ref):
    """max|a - ref| as a share of max|ref| (no floor); inf for a NaN."""
    err = float((a.float() - ref.float()).abs().max())
    return err / float(ref.float().abs().max()) if err == err else float("inf")


@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 37, 256, 256), (3, 2, 70, 64, 96), (1, 3, 5, 128, 32),
                                   (1, 4, 128, 256, 256), (2, 3, 1, 256, 64),
                                   (8, 4, 151, 256, 256), (8, 4, 512, 256, 256)], ids=str)
def test_rwkv6_chunked_route_matches_plain(cuda, st, shape):
    """rwkv6_chunk's chunked route (bf16 IO) against its plain version (the
    same decomposition with tensors) and against the model's plain path, at
    small and ragged shapes, generate's prefill (b8 t151) and the training
    forward (b8 t512), with the RWKV6 gates' -20 resets: o within 1e-2 of
    its own max|plain|, the final state within 1e-3 in f32 (the decayed key
    enters the state update in two bf16 parts) and 1e-2 in bf16 (the
    model's plain path rounds the decayed key once: 1e-2). Counted as one
    launch under its route."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x = _rwkv6_inputs(cuda, *shape, torch.bfloat16, st, seed=11)
    routes, launches = dict(rwkv6_cuda.rwkv6_chunk.routes), rwkv6_cuda.rwkv6_chunk.launches
    with torch.no_grad():
        o, sf = _rwkv6_fwd_call(x, "chunked")
    torch.cuda.synchronize()
    routes["chunked"] += 1
    assert rwkv6_cuda.rwkv6_chunk.routes == routes
    assert rwkv6_cuda.rwkv6_chunk.launches == launches + 1
    assert o.dtype == torch.bfloat16 and sf.dtype == (st or torch.float32)
    for ref, tol_s in (("chunked plain", 1e-2 if st == torch.bfloat16 else 1e-3), ("plain", 1e-2)):
        o_p, sf_p = _rwkv6_fwd_call(x, ref)
        assert _own_max_err(o, o_p) <= 1e-2, ref
        assert _own_max_err(sf, sf_p) <= tol_s, ref


@pytest.mark.parametrize("st", [torch.float32, None])
def test_rwkv6_chunked_route_gives_equal_bits_on_a_second_call(cuda, st):
    """The chunked route sums in a fixed order (no atomics): a second call on
    the same inputs gives the same bits, with A formed in the output kernel
    (b8 t512, split 1) and summed from the key tiles' parts (b1 t130)."""
    for shape in ((8, 4, 512, 256, 256), (1, 4, 130, 256, 256)):
        x = _rwkv6_inputs(cuda, *shape, torch.bfloat16, st, seed=12)
        first = _rwkv6_fwd_call(x, "chunked")
        second = _rwkv6_fwd_call(x, "chunked")
        torch.cuda.synchronize()
        assert all(torch.equal(a, r) for a, r in zip(first, second)), shape


@pytest.mark.parametrize("io,b,t", [(torch.bfloat16, 8, 151), (torch.bfloat16, 1, 128),
                                    (torch.bfloat16, 1, 16), (torch.float32, 8, 151)])
def test_rwkv6_chunk_takes_the_planned_route(cuda, io, b, t):
    """Without a route rwkv6_chunk takes rwkv6_chunk_fwd_plan's (also under
    autograd, the training forward), counts it under its name and notes it
    with the shape; reset_launch_counts clears the routes; a chunked route
    forced onto f32 IO raises and launches nothing."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x = _rwkv6_inputs(cuda, b, 4, t, 256, 256, io, None, seed=13)
    rwkv6_cuda.reset_launch_counts()
    assert rwkv6_cuda.rwkv6_chunk.routes == {"recurrent": 0, "chunked": 0}
    with torch.no_grad():
        _rwkv6_fwd_call(x)
    _rwkv6_grads(rwkv6_cuda.rwkv6_chunk, x)
    route = rwkv6_cuda.rwkv6_chunk_fwd_plan(io, b, 4, t, 256)
    assert rwkv6_cuda.rwkv6_chunk.routes == {"recurrent": 0, "chunked": 0, route: 2}
    assert rwkv6_cuda.launch_counts() == {"rwkv6_chunk": 2, "rwkv6_chunk_bwd": 1,
                                          "rwkv6_decode": 0}
    key = (b, 4, t, 256, 256, io, None, route)
    bwd_key = (b, 4, t, 256, 256, io, None, False,
               rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, 4, t, 256))
    assert rwkv6_cuda.launch_shape_counts() == {"rwkv6_chunk": {key: 2},
                                                "rwkv6_chunk_bwd": {bwd_key: 1},
                                                "rwkv6_decode": {}}
    assert rwkv6_cuda.launch_shapes()["rwkv6_chunk"] == {key}
    if io == torch.float32:
        with pytest.raises(ValueError, match="bf16 IO only"):
            _rwkv6_fwd_call(x, "chunked")
        assert rwkv6_cuda.rwkv6_chunk.launches == 2


def _rwkv6_plain_grads(x, do, dsf):
    """Autograd of sum(o * do) + sum(sf * dsf) through rwkv6_chunk_plain
    w.r.t. r, k, v, w, u (and s0)."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    names = ("r", "k", "v", "w", "u") + (("s0",) if x["s0"] is not None else ())
    leaves = {n: x[n].detach().clone().requires_grad_(True) for n in names}
    o, sf = rwkv6_cuda.rwkv6_chunk_plain(*(leaves[n] for n in names[:5]),
                                         initial_state=leaves.get("s0"))
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    return dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))


def _rwkv6_bwd_case(dev, shape, st, seed):
    """(inputs, do, dsf) of a bf16-IO backward at ``shape``."""
    b, h, t, dk, dv = shape
    x = _rwkv6_inputs(dev, *shape, torch.bfloat16, st, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(b, h, t, dv, generator=g, device=dev).to(torch.bfloat16)
    dsf = torch.randn(b, h, dk, dv, generator=g, device=dev).to(st or torch.float32)
    return x, do, dsf


def _rwkv6_bwd_on_route(x, do, dsf, route):
    """rwkv6_chunk_bwd's launcher forced onto ``route``: {leaf: gradient}."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    out = rwkv6_cuda._chunk_bwd_launch(*(x[n] for n in ("r", "k", "v", "w", "u", "s0")), do,
                                       dsf, True, route)
    return {n: g for n, g in zip(("r", "k", "v", "w", "u", "s0"), out) if g is not None}


@pytest.mark.parametrize("route", ["chunked", "recurrent"])
@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16, None])
@pytest.mark.parametrize("shape", [(2, 4, 70, 256, 256), (1, 2, 130, 128, 96), (3, 2, 5, 64, 64),
                                   (2, 3, 1, 256, 64), (8, 4, 512, 256, 256)], ids=str)
def test_rwkv6_backward_routes_match_plain(cuda, route, st, shape):
    """rwkv6_chunk_bwd (bf16 IO) forced onto each route against autograd
    through the plain version, at ragged and whole chunks, t = 1 and the
    training shape (b8 t512), with the RWKV6 gates' -20 resets: every leaf
    (dr, dk, dv, dw, du, ds0) within 2e-2 of its own max|plain| (dw one step
    from a zero state, 0 in exact arithmetic, to the size of its two
    cancelling terms); the chunked route also against
    rwkv6_chunk_bwd_chunked_plain with bf16 operands within 1e-2. Counted
    as one launch under its route."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x, do, dsf = _rwkv6_bwd_case(cuda, shape, st, seed=21)
    routes, launches = dict(rwkv6_cuda.rwkv6_chunk_bwd.routes), rwkv6_cuda.rwkv6_chunk_bwd.launches
    got = _rwkv6_bwd_on_route(x, do, dsf, route)
    torch.cuda.synchronize()
    routes[route] += 1
    assert rwkv6_cuda.rwkv6_chunk_bwd.routes == routes
    assert rwkv6_cuda.rwkv6_chunk_bwd.launches == launches + 1
    refs = [(_rwkv6_plain_grads(x, do, dsf), 2e-2)]
    if route == "chunked":
        args = (*(x[n] for n in ("r", "k", "v", "w", "u", "s0")), do, dsf)
        plain = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(*args, operand_dtype=torch.bfloat16)
        refs.append(({n: g for n, g in zip(("r", "k", "v", "w", "u", "s0"), plain)
                      if g is not None}, 1e-2))
    for ref, share in refs:
        assert got.keys() == ref.keys()
        for name, r in ref.items():
            a = got[name]
            assert a.dtype == r.dtype and a.shape == r.shape, name
            err = float((a.float() - r.float()).abs().max())
            scale = float(r.float().abs().max())
            if name == "w" and shape[2] == 1 and st is None:
                assert scale <= 1e-6 * float(got["k"].float().abs().max())
                scale = float((x["k"].float() * got["k"].float()).abs().max())
            assert scale > 0 and err <= share * scale, (name, err, share * scale)


@pytest.mark.parametrize("st", [torch.float32, None])
def test_rwkv6_backward_routes_give_equal_bits_on_a_second_call(cuda, st):
    """Both routes of rwkv6_chunk_bwd sum in a fixed order (no atomics): a
    second call on the same inputs gives the same bits, at the training
    shape and at a ragged one."""
    for shape in ((8, 4, 512, 256, 256), (1, 4, 130, 256, 256)):
        x, do, dsf = _rwkv6_bwd_case(cuda, shape, st, seed=22)
        for route in ("chunked", "recurrent"):
            first = _rwkv6_bwd_on_route(x, do, dsf, route)
            second = _rwkv6_bwd_on_route(x, do, dsf, route)
            torch.cuda.synchronize()
            assert all(torch.equal(first[n], second[n]) for n in first), (shape, route)


@pytest.mark.parametrize("io,b,t", [(torch.bfloat16, 8, 512), (torch.bfloat16, 2, 130),
                                    (torch.bfloat16, 1, 16), (torch.float32, 8, 151)])
def test_rwkv6_chunk_bwd_takes_the_planned_route(cuda, io, b, t):
    """Under autograd the backward takes rwkv6_chunk_bwd_plan's route, counts
    it under its name and notes it with the shape; a chunked route forced
    onto f32 IO raises and launches nothing."""
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    x = _rwkv6_inputs(cuda, b, 4, t, 256, 256, io, torch.float32, seed=23)
    rwkv6_cuda.reset_launch_counts()
    _rwkv6_grads(rwkv6_cuda.rwkv6_chunk, x)
    route = rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, 4, t, 256)
    min_t = 64 if b * 4 > 16 else 96
    assert route == ("chunked" if io == torch.bfloat16 and t >= min_t else "recurrent")
    assert rwkv6_cuda.rwkv6_chunk_bwd.routes == {"recurrent": 0, "chunked": 0, route: 1}
    key = (b, 4, t, 256, 256, io, torch.float32, True, route)
    assert rwkv6_cuda.launch_shape_counts()["rwkv6_chunk_bwd"] == {key: 1}
    if io == torch.float32:
        do = torch.zeros(b, 4, t, 256, dtype=io, device=cuda)
        with pytest.raises(ValueError, match="bf16 IO only"):
            _rwkv6_bwd_on_route(x, do, torch.zeros_like(x["s0"]), "chunked")
        assert rwkv6_cuda.rwkv6_chunk_bwd.launches == 1


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


# ------------------------------------------------------------ Mamba (v1)
MAMBA_NAMES = ("x", "dt", "A", "B", "C", "D", "s0")


def _mamba_inputs(dev, b, t, d, io, s0=True, reset=False, seed=0):
    """x, B, C in ``io``; f32 steps dt = softplus(N(-1, 1)), rates A =
    -U(1, 16), D ~ N(0, 1) and an f32 initial state (``s0``); a reset
    mask at 5% of the steps (``reset``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r_ = lambda *s: torch.randn(*s, generator=g, device=dev)
    u_ = lambda *s: torch.rand(*s, generator=g, device=dev)
    return dict(
        x=r_(b, t, d).to(io), dt=torch.nn.functional.softplus(r_(b, t, d) - 1.0),
        A=-(1.0 + 15.0 * u_(d, 16)), B=r_(b, t, 16).to(io), C=r_(b, t, 16).to(io), D=r_(d),
        s0=r_(b, d, 16) if s0 else None, reset=(u_(b, t) < 0.05) if reset else None)


def _mamba_grads(fn, x, seed=3):
    """(y, sf, gradients) of sum(y * dy) + sum(sf * dsf) through ``fn``
    (mamba_scan or its plain version) w.r.t. x, dt, A, B, C, D (and s0)."""
    names = MAMBA_NAMES[:6] + (("s0",) if x["s0"] is not None else ())
    leaves = {n: x[n].detach().clone().requires_grad_(True) for n in names}
    y, sf = fn(*(leaves[n] for n in names[:6]), initial_state=leaves.get("s0"),
               reset_mask=x["reset"])
    g = torch.Generator(device=y.device).manual_seed(seed)
    dy = torch.randn(y.shape, generator=g, device=y.device).to(y.dtype)
    dsf = torch.randn(sf.shape, generator=g, device=y.device)
    loss = (y.float() * dy.float()).sum() + (sf * dsf).sum()
    return y, sf, dict(zip(names, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s0,reset", [(True, False), (False, True)])
@pytest.mark.parametrize("shape", [(8, 151, 2048), (1, 128, 2048), (1, 1, 2048), (3, 37, 96)],
                         ids=str)
def test_mamba_scan_kernel_matches_plain(cuda, io, s0, reset, shape):
    """mamba_scan against its plain version (the time loop): y in the IO
    dtype and the f32 final state, at the flagship's shapes (d 2048: the
    generate prefill b8 t151 and server chunks at b1) and a small ragged one."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    b, t, d = shape
    x = _mamba_inputs(cuda, b, t, d, io, s0, reset)
    args = [x[n] for n in MAMBA_NAMES[:6]]
    before = mamba_cuda.mamba_scan.launches
    y, sf = mamba_cuda.mamba_scan(*args, initial_state=x["s0"], reset_mask=x["reset"])
    y_p, sf_p = mamba_cuda.mamba_scan_plain(*args, initial_state=x["s0"], reset_mask=x["reset"])
    torch.cuda.synchronize()
    assert mamba_cuda.mamba_scan.launches == before + 1
    assert y.dtype == io and sf.dtype == torch.float32
    assert _rel_err(y, y_p) <= (1e-4 if io == torch.float32 else 1e-2)
    assert _rel_err(sf, sf_p) <= 1e-4


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [((2, 150, 96), 32), ((3, 70, 64), 16),
                                         ((1, 130, 2048), 16), ((1, 300, 2048), 64)], ids=str)
def test_mamba_scan_routes_match_plain(cuda, io, shape, chunk):
    """The forward on both routes, forced: chunks of ``chunk`` (a ragged
    last one; resets at 5% of the steps and on a chunk's first step; an
    initial state; d 96 leaves the last 64-channel group half empty) and one
    chunk, against mamba_scan_plain and mamba_scan_chunked_plain at the same
    length: y within 1e-2 of max(1, max|plain|) in bf16 IO, 1e-4 in f32,
    the f32 final state within 1e-4; the same bits on a second call; each
    call one launch, counted under its route and noted with its length."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    b, t, d = shape
    x = _mamba_inputs(cuda, b, t, d, io, s0=True, reset=True, seed=17)
    x["reset"][:, chunk] = True
    args = [x[n] for n in MAMBA_NAMES[:6]] + [x["s0"], x["reset"]]
    ref = mamba_cuda.mamba_scan_plain(*args)
    tol = 1e-4 if io == torch.float32 else 1e-2
    whole = -(-t // 16) * 16
    mamba_cuda.reset_launch_counts()
    for length in (chunk, whole):
        got = mamba_cuda._scan_launch(*args, chunk=length)
        again = mamba_cuda._scan_launch(*args, chunk=length)
        plain = mamba_cuda.mamba_scan_chunked_plain(*args, chunk=length)
        torch.cuda.synchronize()
        assert got[0].dtype == io and got[1].dtype == torch.float32
        for r in (ref, plain):
            assert _rel_err(got[0], r[0]) <= tol and _rel_err(got[1], r[1]) <= 1e-4, length
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]), length
    key = (b, t, d, 16, io, torch.float32, True)
    assert mamba_cuda.launch_counts() == {"mamba_scan": 4, "mamba_scan_bwd": 0}
    assert mamba_cuda.mamba_scan.routes == {"one_chunk": 2, "chunked": 2}
    assert mamba_cuda.launch_shape_counts()["mamba_scan"] == {(*key, chunk): 2, (*key, whole): 2}


@pytest.mark.parametrize("b,t", [(1, 128), (2, 319), (8, 151), (1, 16)])
def test_mamba_scan_takes_the_planned_chunk_length(cuda, b, t):
    """The public wrapper, with and without autograd recording, launches
    the forward at the chunk length mamba_scan_plan gives (chunks at small
    batches, one chunk at b8 and on a few steps), one launch a call counted
    under its route."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    x = _mamba_inputs(cuda, b, t, 2048, torch.bfloat16, s0=True, seed=19)
    chunk = mamba_cuda.mamba_scan_plan(b, t, 2048)
    mamba_cuda.reset_launch_counts()
    with torch.no_grad():
        mamba_cuda.mamba_scan(*(x[n] for n in MAMBA_NAMES[:6]), initial_state=x["s0"])
    _mamba_grads(mamba_cuda.mamba_scan, x)
    route = mamba_cuda.bwd_route(t, chunk)
    assert (route == "one_chunk") == ((b, t) in ((8, 151), (1, 16)))
    assert mamba_cuda.launch_counts() == {"mamba_scan": 2, "mamba_scan_bwd": 1}
    assert mamba_cuda.mamba_scan.routes == {"one_chunk": 0, "chunked": 0, route: 2}
    assert mamba_cuda.launch_shape_counts()["mamba_scan"] == {
        (b, t, 2048, 16, torch.bfloat16, torch.float32, False, chunk): 2}


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s0,reset", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(2, 70, 256), (1, 16, 64), (2, 1, 32)], ids=str)
def test_mamba_scan_backward_kernel_matches_plain_backward(cuda, io, s0, reset, shape):
    """mamba_scan under autograd runs the forward kernel and the hand-written
    backward (one launch each); every gradient (dx, ddt, dA, dB, dC, dD,
    ds0) matches autograd through the plain loop within a share of its own
    max|plain|, and a second backward gives the same bits (no atomics)."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    x = _mamba_inputs(cuda, *shape, io, s0, reset, seed=7)
    before = mamba_cuda.launch_counts()
    y, sf, got = _mamba_grads(mamba_cuda.mamba_scan, x)
    after = mamba_cuda.launch_counts()
    assert after == {"mamba_scan": before["mamba_scan"] + 1,
                     "mamba_scan_bwd": before["mamba_scan_bwd"] + 1}
    again = _mamba_grads(mamba_cuda.mamba_scan, x)[2]
    y_p, sf_p, ref = _mamba_grads(mamba_cuda.mamba_scan_plain, x)
    assert _rel_err(y.detach(), y_p.detach()) <= (1e-4 if io == torch.float32 else 1e-2)
    assert _rel_err(sf.detach(), sf_p.detach()) <= 1e-4
    share = 2e-2 if io == torch.bfloat16 else 1e-3
    for name, r in ref.items():
        a = got[name]
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert torch.equal(a, again[name]), name
        err, scale = float((a.float() - r.float()).abs().max()), float(r.float().abs().max())
        if name == "A" and shape[1] == 1 and not s0:
            # one step from a zero state: dA = dt g h_{-1} a is 0 on both sides
            assert err == scale == 0
            continue
        assert scale > 0 and err <= share * scale, (name, err, scale)


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [((2, 150, 96), 32), ((3, 70, 64), 16),
                                         ((1, 300, 2048), 64)], ids=str)
def test_mamba_scan_bwd_chunked_route_matches_plain(cuda, io, shape, chunk):
    """The backward's chunked route (several chunks, a ragged last one;
    resets at 5% of the steps and on a chunk's first step; an initial
    state; d 96 leaves the last 64-channel group half empty) against
    autograd through the plain loop and against
    mamba_scan_bwd_chunked_plain at the same chunk length, every leaf within
    a share of its own max|plain|; each call one launch counted under
    "chunked", the same bits on a second call; the one-chunk route on the
    same inputs agrees too."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    b, t, d = shape
    x = _mamba_inputs(cuda, b, t, d, io, s0=True, reset=True, seed=11)
    x["reset"][:, chunk] = True
    _, _, ref = _mamba_grads(mamba_cuda.mamba_scan_plain, x)
    g = torch.Generator(device=cuda).manual_seed(3)  # the cotangents _mamba_grads drew
    dy = torch.randn(b, t, d, generator=g, device=cuda).to(io)
    dsf = torch.randn(b, d, 16, generator=g, device=cuda)
    args = [x[n] for n in MAMBA_NAMES[:6]] + [x["s0"], x["reset"], dy, dsf]
    mamba_cuda.reset_launch_counts()
    got = mamba_cuda._bwd_launch(*args, chunk=chunk)
    again = mamba_cuda._bwd_launch(*args, chunk=chunk)
    assert mamba_cuda.launch_counts()["mamba_scan_bwd"] == 2
    assert mamba_cuda.mamba_scan_bwd.routes == {"one_chunk": 0, "chunked": 2}
    one = mamba_cuda._bwd_launch(*args, chunk=-(-t // 16) * 16)
    assert mamba_cuda.mamba_scan_bwd.routes == {"one_chunk": 1, "chunked": 2}
    plain = mamba_cuda.mamba_scan_bwd_chunked_plain(*args, chunk=chunk)
    share = 2e-2 if io == torch.bfloat16 else 1e-3
    for i, name in enumerate(MAMBA_NAMES):
        r = ref[name]
        for other in (got[i], one[i], plain[i]):
            assert other.dtype == r.dtype and other.shape == r.shape, name
            err, scale = float((other.float() - r.float()).abs().max()), float(r.float().abs().max())
            assert scale > 0 and err <= share * scale, (name, err, scale)
        assert torch.equal(got[i], again[i]), name


def test_mamba_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """kernel_takes refuses a state size other than 16, channels that are
    no multiple of 32 and a bf16 state, and the wrapper given such inputs
    (or a bf16 dt, or a float reset mask) raises instead of running the
    plain version; the plain route launches nothing."""
    from lina_speech_tpu_torch.ops import mamba_cuda

    assert mamba_cuda.kernel_takes(2048, 16, torch.bfloat16, torch.float32)
    assert not mamba_cuda.kernel_takes(2048, 8, torch.bfloat16, torch.float32)
    assert not mamba_cuda.kernel_takes(48, 16, torch.float32, torch.float32)
    assert not mamba_cuda.kernel_takes(64, 16, torch.float32, torch.bfloat16)
    x = _mamba_inputs(cuda, 2, 8, 64, torch.bfloat16)
    args = [x[n] for n in MAMBA_NAMES[:6]]
    with pytest.raises(ValueError):  # channels the kernels do not take
        mamba_cuda.mamba_scan(*_mamba_inputs(cuda, 2, 8, 48, torch.bfloat16).values())
    with pytest.raises(ValueError):  # bf16 initial state
        mamba_cuda.mamba_scan(*args, initial_state=x["s0"].bfloat16())
    with pytest.raises(ValueError):  # bf16 steps
        mamba_cuda.mamba_scan(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(ValueError):  # a float reset mask
        mamba_cuda.mamba_scan(*args, reset_mask=torch.zeros(2, 8, device=cuda))
    mamba_cuda.reset_launch_counts()
    mamba_cuda.mamba_scan_plain(*args, initial_state=x["s0"])
    assert mamba_cuda.launch_counts() == {"mamba_scan": 0, "mamba_scan_bwd": 0}


def test_mamba_kernel_path_matches_plain_path(cuda):
    """The Mamba (v1) backbone at a width the kernels take (d_model 256:
    d_inner 512, d_state 16) in f32, with A_log, D and dt_proj's bias drawn
    off their inits: greedy tokens of the kernel path (mamba_scan for the
    prefill; decode is the plain step on both paths) equal the plain path's,
    and the training forward's parameter gradients (mamba_scan's backward)
    match."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.mamba import perturb_mamba_params_
    from lina_speech_tpu_torch.ops import mamba_cuda
    from lina_speech_tpu_torch.train.harness import batch_to_device

    cfg = _variant_cfg(kind="mamba")
    text = torch.randint(3, 256, (3, 9), generator=torch.Generator().manual_seed(0)).to(cuda)
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_codebook=50, min_audio_len=16, max_audio_len=24)), cuda)
    tokens, grads = {}, {}
    model = build_model(cfg, device=cuda, seed=3)
    perturb_mamba_params_(model, torch.Generator().manual_seed(4))
    n_layers = 2 * cfg.backbone.n_layer + 1
    for mode in ("auto", "chunk"):
        model.set_kernel_mode(mode)
        mamba_cuda.reset_launch_counts()
        res = generate_batch(model, text, max_seqlen=20, first_greedy_quant=0,
                             force_max_seqlen=True)
        model.zero_grad(set_to_none=True)
        model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
              batch["crossatt_mask"], logits_mask=batch["y_mask"])[1].backward()
        counts = mamba_cuda.launch_counts()
        want = dict.fromkeys(counts, 0)
        if mode == "auto":
            want.update(mamba_scan=2 * n_layers, mamba_scan_bwd=n_layers)
        assert counts == want
        tokens[mode] = res.tokens.cpu()
        grads[mode] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert torch.equal(tokens["auto"], tokens["chunk"])
    for name, r in grads["chunk"].items():
        err = float((grads["auto"][name] - r).abs().max())
        assert err <= 1e-3 * float(r.abs().max()) + 1e-6, name


TOL_CODEC = 1e-4  # f32 with TF32 off; each tensor to its own max|ref|, as chip_smoke.py


@pytest.mark.parametrize("kw", [
    dict(ratios=(4, 2), n_filters=2, latent_dim=16, bins=32, backbone_dim=32,
         backbone_intermediate_dim=64, backbone_layers=1, n_fft=16, hop_length=8),
    dict(backbone_layers=2)], ids=["tiny", "flagship_widths"])
def test_codec_on_cuda_matches_cpu(cuda, kw):
    """``build_wavtokenizer`` with no device builds on the card; its
    encode and codes_to_audio there match the same module on the CPU."""
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer

    cfg = WavTokenizerConfig(**kw)
    card = build_wavtokenizer(cfg, seed=5)
    assert card.device.type == "cuda" and all(p.is_cuda for p in card.parameters())
    cpu = build_wavtokenizer(cfg, device="cpu", seed=5)
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, cfg.bins, (1, 2, 40), generator=g)
    audio = torch.randn(2, 6 * cfg.hop, generator=g) * 0.1
    with torch.no_grad():
        wav, ref = card.codes_to_audio(codes.to(cuda)).cpu(), cpu.codes_to_audio(codes)
        lat, lat_ref = card.encoder(audio.to(cuda)).cpu(), cpu.encoder(audio)
    for out, r in ((wav, ref), (lat, lat_ref)):
        assert out.shape == r.shape and bool(torch.isfinite(out).all())
        assert float((out - r).abs().max()) <= TOL_CODEC * float(r.abs().max())


def test_cfg_generate_kernel_path_matches_plain_path(cuda):
    """Classifier-free guidance on the card: greedy guided generation in
    f32 on a small model whose heads the kernels take, at batch 3 (the
    kernels run at 6 rows), gives the plain path's tokens; every prefill and
    decode kernel launch runs at the doubled batch."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.generate import generate_batch

    cfg = lina_gla_tiny(mask_text_p=0.1)
    cfg = dataclasses.replace(cfg, d_model=256, backbone=dataclasses.replace(
        cfg.backbone, d_model=256, heads=4, pos_type="convolutional"),
        text_encoder=dataclasses.replace(cfg.text_encoder, dim=256))
    text = torch.randint(3, 256, (3, 9), generator=torch.Generator().manual_seed(0)).to(cuda)
    prompt = torch.randint(0, 50, (1, 3, 12), generator=torch.Generator().manual_seed(1)).to(cuda)
    model = build_model(cfg, device=cuda, seed=3)
    n_layers = len(model.attentive_rnn.gla_layers())
    tokens = {}
    for mode in ("auto", "chunk"):
        model.set_kernel_mode(mode)
        gla_cuda.reset_launch_counts()
        res = generate_batch(model, text, prompt=prompt, max_seqlen=30, first_greedy_quant=0,
                             force_max_seqlen=True, cfg_coef=2.5)
        counts = gla_cuda.launch_counts()
        want = dict.fromkeys(counts, 0)
        if mode == "auto":
            want.update(gla_chunk_conv=n_layers, gla_decode_conv=n_layers * (30 - 13))
            assert {b for (b, *_) in gla_cuda.launch_shapes()["gla_decode_conv"]} == {6}
        assert counts == want
        tokens[mode] = res.tokens.cpu()
    assert torch.equal(tokens["auto"], tokens["chunk"])


def test_transformer_prefill_matches_decode_on_the_card(cuda):
    """The softmax transformer (d 256, 4 heads, the cross-attention after
    block 1 of 2) in f32 on the card: token-by-token decode against its own
    prefill, and the prefill against the same model on the CPU, logits
    within 1e-3 of their max; the KV clocks equal the lengths."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny

    cfg = lina_gla_tiny()
    cfg = dataclasses.replace(cfg, d_model=256, backbone=dataclasses.replace(
        cfg.backbone, d_model=256, heads=4, kind="transformer"),
        text_encoder=dataclasses.replace(cfg.text_encoder, dim=256))
    g = torch.Generator().manual_seed(0)
    text = torch.randint(3, 256, (2, 9), generator=g)
    codes = torch.randint(3, 53, (1, 2, 20), generator=g)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = build_model(cfg, device=dev, seed=3)
        with torch.no_grad():
            x_enc = model.encode_text(text.to(dev))
            y = model.embed_tokens(codes.to(dev))
            full, _, st_full = model.prefill(y, x_enc, model.empty_state(2, device=dev))
            st, steps = model.empty_state(2, device=dev), []
            for t in range(y.shape[1]):
                lg, _, st = model.decode_step(y[:, t], x_enc, st, time_step=t)
                steps.append(lg)
        assert st.layers[0].t == st_full.layers[-1].t == 20
        out[dev.type] = full.cpu(), torch.stack(steps, 1).cpu()
    full, steps = out["cuda"]
    scale = float(full.abs().max())
    assert float((steps - full).abs().max()) <= 1e-3 * scale
    assert float((full - out["cpu"][0]).abs().max()) <= 1e-3 * float(out["cpu"][0].abs().max())
