"""The port's RWKV6 backbone vs the JAX package, on the CPU.

The ops first: the port's plain ``rwkv6_scan_ref``, ``rwkv6_chunk`` and
``rwkv6_decode_step`` against the JAX package's, and against its Pallas
kernels (``rwkv6_chunk_pallas``, ``rwkv6_decode_fused``) run in interpret
mode as tests/test_rwkv6_pallas.py runs them, with hard resets and an
initial state, in f32 within 2e-4; the gradients (dr, dk, dv, dw, du, ds0)
of autograd through the port's chunked form against JAX's hand-written VJP
within 1e-3 of each leaf's max; bf16 IO against JAX's rounding points.

Then the model: ``lina_gla_tiny`` with ``kind="rwkv6"`` (d 64, 2 heads of
dk 32), initialized by JAX, its bonus, ddlerp mixes and decays moved off
their constant inits with numpy from a seed, and loaded into the port
through ``utils/convert.py``. Both sides compute in f32: logits and loss
within 3e-4 (tests/test_variants.py), every parameter's gradient within
1e-4 of its own max, prefill and decode states, the [8, 4, 1] chunked
prefill, greedy ``generate_batch`` and ``DecodeServer`` tokens token for
token (also on int8 weights); lazy windows, int8 states and S0 tuning
raise, as in JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lina_speech_tpu.config import build_model as jax_build, lina_gla_tiny
from lina_speech_tpu.generate import generate_batch as jax_generate
from lina_speech_tpu.ops import rwkv6 as jax_ops
from lina_speech_tpu.ops.gla_pallas import rwkv6_decode_fused
from lina_speech_tpu.ops.rwkv6_pallas import rwkv6_chunk_pallas
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.rwkv6 import RWKV6Attention, RWKV6State
from lina_speech_tpu_torch.ops import rwkv6 as ops
from lina_speech_tpu_torch.ops import rwkv6_cuda
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, load_jax_params, named_tensors_to_jax,
)
from test_torch_model import _train_batch

TOL_OP = 2e-4
TOL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(t, j, tol):
    """``t`` within ``tol`` of its reference's own max|j| (no floor)."""
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    err, ref = float(np.abs(t - j).max()), float(np.abs(j).max())
    assert ref > 0 and err <= tol * ref, (err, ref)


# ------------------------------------------------------------------- ops
def _op_inputs(seed, b=2, h=2, t=37, dk=16, dv=24, reset=True, s0=True):
    """r, k, v, w (with hard resets), u and s0 as numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = -np.exp(n(b, h, t, dk) * 0.5 - 2.0)
    if reset:
        w = np.where(rng.random((b, 1, t, 1)) < 0.08, -20.0, w).astype(np.float32)
    return dict(r=n(b, h, t, dk), k=n(b, h, t, dk), v=n(b, h, t, dv), w=w, u=n(h, dk) * 0.5,
                s0=n(b, h, dk, dv) if s0 else None)


def _both(x, names=("r", "k", "v", "w", "u")):
    return [jnp.asarray(x[n]) for n in names], [torch.from_numpy(x[n]) for n in names]


@pytest.mark.parametrize("t,reset,s0", [(37, True, True), (64, False, True), (5, True, False)])
def test_scan_and_chunk_match_jax_and_the_pallas_kernel(t, reset, s0):
    """The port's plain scan and chunked form against JAX's two and against
    rwkv6_chunk_pallas in interpret mode: o and the final state."""
    x = _op_inputs(t, t=t, reset=reset, s0=s0)
    jargs, targs = _both(x)
    js0 = None if x["s0"] is None else jnp.asarray(x["s0"])
    ts0 = None if x["s0"] is None else torch.from_numpy(x["s0"])
    ref = jax_ops.rwkv6_scan_ref(*jargs, initial_state=js0)
    pallas = rwkv6_chunk_pallas(*jargs, initial_state=js0, chunk_size=16, interpret=True)
    jchunk = jax_ops.rwkv6_chunk(*jargs, initial_state=js0)
    for got in (ops.rwkv6_scan_ref(*targs, initial_state=ts0),
                ops.rwkv6_chunk(*targs, initial_state=ts0),
                rwkv6_cuda.rwkv6_chunk(*targs, initial_state=ts0)):
        for g, want in zip(got, ref):
            _close(g, want, TOL_OP)
        for g, j in zip(got, jchunk):
            _close(g, j, TOL_OP)
        for g, j in zip(got, pallas):
            _close(g, j, TOL_OP)


def test_chunk_bf16_io_keeps_jax_rounding_points():
    """bf16 r, k, v: the port's chunked form rounds its matmul operands to
    bf16 where JAX does (the inter-chunk state included) and returns bf16
    o and an f32 state; against JAX's chunked form within one bf16 step of
    o's max."""
    x = _op_inputs(3, t=70)
    jargs = [jnp.asarray(x[n], jnp.bfloat16) for n in ("r", "k", "v")]
    targs = [torch.from_numpy(x[n]).to(torch.bfloat16) for n in ("r", "k", "v")]
    jo, js = jax_ops.rwkv6_chunk(*jargs, jnp.asarray(x["w"]), jnp.asarray(x["u"]),
                                 initial_state=jnp.asarray(x["s0"]))
    to, ts = ops.rwkv6_chunk(*targs, torch.from_numpy(x["w"]), torch.from_numpy(x["u"]),
                             initial_state=torch.from_numpy(x["s0"]))
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _close(to, np.asarray(jo, np.float32), 2 ** -8)
    _close(ts, js, 1e-5)
    # the plain scan keeps f32 operands: it differs from the chunked form by
    # the rounding of the state for the inter-chunk product
    so, _ = ops.rwkv6_scan_ref(*targs, torch.from_numpy(x["w"]), torch.from_numpy(x["u"]),
                               initial_state=torch.from_numpy(x["s0"]))
    _close(to, so.float().numpy(), 2e-2)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_decode_step_matches_jax_and_the_pallas_kernel(state_dtype):
    """One token from a state: the port's plain step (and the wrapper on
    CPU tensors) against JAX's step and rwkv6_decode_fused in interpret mode;
    the state keeps its dtype."""
    x = _op_inputs(11, b=3, t=1, dk=32, dv=32)
    names = ("r", "k", "v", "w")
    j = [jnp.asarray(x[n][:, :, 0]) for n in names] + [jnp.asarray(x["u"])]
    t = [torch.from_numpy(x[n][:, :, 0]) for n in names] + [torch.from_numpy(x["u"])]
    jdt = jnp.float32 if state_dtype == torch.float32 else jnp.bfloat16
    js = jnp.asarray(x["s0"]).astype(jdt)
    ts = torch.from_numpy(x["s0"]).to(state_dtype)
    refs = [jax_ops.rwkv6_decode_step(*j, js), rwkv6_decode_fused(*j, js, interpret=True)]
    tol = TOL_OP if state_dtype == torch.float32 else 2 ** -8
    for got in (ops.rwkv6_decode_step(*t, ts), rwkv6_cuda.rwkv6_decode(*t, ts)):
        assert got[1].dtype == state_dtype
        for ref in refs:
            _close(got[0], ref[0], tol)
            _close(got[1], np.asarray(ref[1], np.float32), tol)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_is_the_classic_steps_plan(state_dtype):
    """rwkv6_decode_plan gives gla_decode_plan's route at every shape and
    state dtype (the two steps share the kernel's bodies): the tile body on
    a state of at most 512 KiB, else the wide route decode_wide_route
    gives; RWKV6's flagship head at b8 on its f32 state takes wide8."""
    from lina_speech_tpu_torch.ops import gla_cuda

    for b in (1, 2, 3, 4, 6, 8, 16, 64, 128):
        for h, dk, dv in ((4, 256, 256), (4, 256, 512), (2, 64, 64), (3, 128, 96)):
            route = rwkv6_cuda.rwkv6_decode_plan(b, h, dk, dv, state_dtype)
            assert route == gla_cuda.gla_decode_plan(b, h, dk, dv, state_dtype)
            small = b * h * dk * dv * state_dtype.itemsize <= 1 << 19
            assert (route == "tile") == small, (b, h, dk, dv)
            if not small:
                assert route == gla_cuda.decode_wide_route(b, h, dv, state_dtype)
    assert rwkv6_cuda.rwkv6_decode_plan(8, 4, 256, 256, torch.float32) == "wide8"


def test_decode_launcher_refuses_what_its_routes_do_not_take():
    """The decode step's launcher raises on a route the kernel has not and
    on a wide route over a state off a 16-byte boundary (read and written
    in 16-byte words), before anything is built or launched; nothing is
    counted."""
    x = _op_inputs(12, b=1, h=2, t=1, dk=64, dv=64)
    tok = [torch.from_numpy(x[n][:, :, 0]).contiguous() for n in ("r", "k", "v", "w")]
    u, s0 = torch.from_numpy(x["u"]), torch.from_numpy(x["s0"])
    off = torch.empty(s0.numel() + 1)[1:].view(s0.shape)
    off.copy_(s0)
    rwkv6_cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="route"):
        rwkv6_cuda._decode_launch(*tok, u, s0, route="rows")
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_cuda._decode_launch(*tok, u, off, route="wide4")
    assert rwkv6_cuda.launch_counts()["rwkv6_decode"] == 0
    assert rwkv6_cuda.rwkv6_decode.routes == dict.fromkeys(rwkv6_cuda.rwkv6_decode.routes, 0)
    assert not rwkv6_cuda.launch_shape_counts()["rwkv6_decode"]


def test_chunk_gradients_match_jax_handwritten_vjp():
    """Autograd through the port's chunked form (the backward the CPU
    trains with, and what the CUDA backward is held against) against the
    JAX Pallas kernel's hand-written VJP in interpret mode: dr, dk, dv, dw,
    du and ds0, each within 1e-3 of its own max."""
    x = _op_inputs(5, t=40, dk=16, dv=16)
    rng = np.random.default_rng(6)
    do = rng.standard_normal(x["v"].shape).astype(np.float32)
    dsf = rng.standard_normal(x["s0"].shape).astype(np.float32)
    names = ("r", "k", "v", "w", "u", "s0")

    def jloss(*a):
        o, s = rwkv6_chunk_pallas(*a[:5], initial_state=a[5], chunk_size=16, interpret=True,
                                  residual_dtype=jnp.float32)
        return jnp.sum(o * do) + jnp.sum(s * dsf)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(x[n]) for n in names))
    leaves = [torch.from_numpy(x[n]).requires_grad_(True) for n in names]
    o, s = ops.rwkv6_chunk(*leaves[:5], initial_state=leaves[5])
    loss = (o * torch.from_numpy(do)).sum() + (s * torch.from_numpy(dsf)).sum()
    tgrads = torch.autograd.grad(loss, leaves)
    for name, g, j in zip(names, tgrads, jgrads):
        assert g.shape == j.shape, name
        _close(g, j, 1e-3)


def test_wrappers_on_the_cpu_take_the_plain_versions_and_count_nothing():
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; the backward wrapper runs on CUDA tensors only. kernel_takes
    refuses the tiny config's heads (dk 32) and int8 states."""
    x = _op_inputs(8, t=9, dk=64, dv=64)
    _, targs = _both(x)
    s0 = torch.from_numpy(x["s0"])
    rwkv6_cuda.reset_launch_counts()
    o, s = rwkv6_cuda.rwkv6_chunk(*targs, initial_state=s0)
    op, sp = rwkv6_cuda.rwkv6_chunk_plain(*targs, initial_state=s0)
    assert torch.equal(o, op) and torch.equal(s, sp)
    tok = [a[:, :, 0].contiguous() for a in targs[:4]]
    o, s1 = rwkv6_cuda.rwkv6_decode(*tok, targs[4], s0)
    assert s1 is not s0 and torch.equal(o, rwkv6_cuda.rwkv6_decode_plain(*tok, targs[4], s0)[0])
    assert rwkv6_cuda.launch_counts() == {"rwkv6_chunk": 0, "rwkv6_chunk_bwd": 0,
                                          "rwkv6_decode": 0}
    assert all(not v for v in rwkv6_cuda.launch_shapes().values())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6_cuda.rwkv6_chunk_bwd(*targs, s0, torch.zeros(2, 2, 9, 64), torch.zeros_like(s0))
    assert rwkv6_cuda.kernel_takes(256, 256, torch.bfloat16, torch.float32)
    assert not rwkv6_cuda.kernel_takes(32, 32, torch.float32, torch.float32)
    assert not rwkv6_cuda.kernel_takes(256, 256, torch.float32, torch.int8)


# ------------------------------------------------------------------ model
def _perturbed(params, seed=0):
    """The JAX params with every RWKV6 layer's bonus ~ N(0, 0.5), ddlerp
    mixes ~ U(0, 1) and decays ~ U(-8, 1) (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, params), sep="/")
    draw = {"time_faaaa": lambda s: rng.standard_normal(s) * 0.5,
            "maa": lambda s: rng.random(s), "x_maa": lambda s: rng.random(s),
            "time_decay": lambda s: rng.random(s) * 9 - 8}
    hit = 0
    for path, val in flat.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in draw:
            flat[path] = draw[leaf](val.shape).astype(np.float32)
            hit += 1
    assert hit == 4 * 5  # 2 + 2 blocks and the pos_net
    return traverse_util.unflatten_dict(flat, sep="/")


_PAIR = {}


def _pair():
    """(jax model, perturbed jax params, port model with the same weights)."""
    if not _PAIR:
        cfg = lina_gla_tiny()
        jm = jax_build(dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, kind="rwkv6")))
        b, m, n = 2, 7, 9
        params = _perturbed(jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32), jnp.ones((b, n, 1), jnp.int32),
            jnp.ones((b, m, m), bool), jnp.ones((b, n, m), bool), jnp.ones((b, n), bool)))
        tcfg = torch_tiny()
        tm = torch_build(dataclasses.replace(tcfg, backbone=dataclasses.replace(
            tcfg.backbone, kind="rwkv6")), device="cpu")
        _PAIR["pair"] = (jm, params, load_jax_params(tm, params).eval())
    return _PAIR["pair"]


def _jax_state_arrays(state):
    out = {}
    named = [(f"layers/{i}", st) for i, st in enumerate(state.layers)]
    named.append(("pos_net", state.pos_net))
    for prefix, st in named:
        for f in dataclasses.fields(st):
            out[f"{prefix}/{f.name}"] = np.asarray(getattr(st, f.name), np.float32)
    return out


def _hold_states(got, ref, tol):
    got, ref = backbone_state_to_arrays(got), _jax_state_arrays(ref)
    assert set(got) == set(ref) and len(ref) == 2 * 5
    for key in ref:
        _close(got[key], ref[key], tol)


def _text_codes(seed, n=10):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, n))


def test_build_matches_jax_parameter_for_parameter():
    """build_model(kind="rwkv6") builds the JAX structure: every JAX param
    has its port parameter of the same shape and values after loading (the
    raw parameters untransposed), and the 3-D maa_w2 keeps its layout."""
    _, params, tm = _pair()
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    got = named_tensors_to_jax(tm.named_parameters())
    assert set(got) == set(flat)
    for path, val in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(val), err_msg=path)
    layer = tm.attentive_rnn.encoder[0].tmix
    assert isinstance(layer, RWKV6Attention) and layer.maa_w2.shape == (5, 32, 64)


def test_forward_logits_loss_and_gradients_match_jax():
    """The training forward on a packed batch (reset_mask wipes the state at
    each segment start, log-decay -20; crossatt_pos) with a logits_mask:
    logits and loss within 3e-4, and the gradient of every parameter by
    name against jax.value_and_grad within 1e-4 of its own max (plus 1e-7
    for the attention's key-side bias, zero in exact arithmetic)."""
    jm, params, tm = _pair()
    batch = _train_batch("packed")
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")

    def loss_fn(p):
        logits, loss, _ = jm.apply(p, *(jnp.asarray(batch[k]) for k in keys),
                                   logits_mask=jnp.asarray(batch["y_mask"]),
                                   reset_mask=jnp.asarray(batch["reset_mask"]),
                                   crossatt_pos=jnp.asarray(batch["crossatt_pos"]))
        return loss, logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    logits, loss, _ = tm(*(tb[k] for k in keys), logits_mask=tb["y_mask"],
                         reset_mask=tb["reset_mask"], crossatt_pos=tb["crossatt_pos"])
    _close(logits, jlogits, TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    loss.backward()
    got = named_tensors_to_jax({n: p.grad for n, p in tm.named_parameters()})
    ref = traverse_util.flatten_dict(jgrads["params"], sep="/")
    assert set(got) == set(ref)
    for path, r in ref.items():
        r = np.asarray(r, np.float32)
        err = float(np.abs(got[path] - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-7, (path, err, float(np.abs(r).max()))
    tm.zero_grad(set_to_none=True)


def test_prefill_decode_and_states_match_jax():
    """Prefill logits and final states (s and shift of every block) against
    the JAX prefill; one decode step from that state against JAX's; the
    port's token-by-token decode from an empty state against its own
    prefill (tests/test_variants.py); the states cross to and from arrays."""
    jm, params, tm = _pair()
    text, codes = _text_codes(6)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        logits, _, st = m.prefill(y[:, :-1], x_enc, m.empty_state(text.shape[0]))
        logits_t, _, st_t = m.decode_step(y[:, -1], x_enc, st, time_step=9)
        return logits, st, logits_t, st_t

    jl, jst, jl_t, jst_t = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jrun)
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        empty = tm.empty_state(2)
        assert isinstance(empty.layers[0], RWKV6State) and empty.layers[0].shift.dtype == \
            torch.float32
        tl, _, st = tm.prefill(y[:, :-1], x_enc, empty)
        _close(tl, jl, TOL)
        _hold_states(st, jst, TOL)
        tl_t, _, st_t = tm.decode_step(y[:, -1], x_enc, st, time_step=9)
        _close(tl_t, jl_t, TOL)
        _hold_states(st_t, jst_t, TOL)
        # the JAX state crosses into the port and steps the same
        tl_j, _, _ = tm.decode_step(y[:, -1], x_enc, backbone_state_from_arrays(jst), time_step=9)
        _close(tl_j, jl_t, TOL)
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, steps = tm.empty_state(2), []
        for t in range(y.shape[1]):
            lg, _, st = tm.decode_step(y[:, t], x_enc, st, time_step=t)
            steps.append(lg)
    _close(torch.stack(steps, 1), full.numpy(), TOL)
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_chunked_prefill_matches_one_shot_and_jax():
    """A prefill as [8, 4, 1] chunks (the shift buffer carried; conv_history
    and time_offset from the second on) equals the one-shot prefill, logits
    and final state, and the JAX package run over the same chunks."""
    jm, params, tm = _pair()
    text, codes = _text_codes(7, n=13)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        st, off, outs = m.empty_state(text.shape[0]), 0, []
        for i, c in enumerate([8, 4, 1]):
            lg, _, st = m.prefill(y[:, off:off + c], x_enc, st, conv_history=i > 0,
                                  time_offset=off)
            outs.append(lg)
            off += c
        return jnp.concatenate(outs, axis=1), st

    jl, jst = jm.apply(params, jnp.asarray(text), jnp.asarray(codes), method=jrun)
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, off, outs = tm.empty_state(2), 0, []
        for i, c in enumerate([8, 4, 1]):
            lg, _, st = tm.prefill(y[:, off:off + c], x_enc, st, conv_history=i > 0,
                                   time_offset=off)
            outs.append(lg)
            off += c
    chunked = torch.cat(outs, 1)
    _close(chunked, jl, TOL)
    _close(chunked, full.numpy(), TOL)
    _hold_states(st, jst, TOL)
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8-weights"])
def test_greedy_generate_matches_jax(quant):
    """Greedy generate_batch with a prompt (classic token loop), token for
    token against the JAX package; with ``weight_quant="int8"`` the five
    projections of every RWKV6 layer run on int8 copies on both sides."""
    jm, params, tm = _pair()
    rng = np.random.default_rng(3)
    x = rng.integers(3, 256, size=(2, 8))
    prompt = rng.integers(0, 50, size=(1, 2, 5))
    kw = dict(max_seqlen=16, first_greedy_quant=0, force_max_seqlen=True)
    if quant:
        kw.update(weight_quant="int8", quant_min_size=1 << 8)
    jres = jax_generate(jm, params, jnp.asarray(x), jax.random.PRNGKey(0),
                        prompt=jnp.asarray(prompt), **kw)
    tres = generate_batch(tm, torch.from_numpy(x), prompt=torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.lengths.numpy(), np.asarray(jres.lengths))
    if quant:
        assert tm.attentive_rnn.encoder[0].tmix.r_proj.int8_q is not None


def test_classic_server_matches_jax_generate():
    """DecodeServer in classic mode, two slots recycled by three requests:
    each completion equals the JAX package's greedy generate_batch of that
    request, token for token (the slot machinery infers the batch axis of s
    and of the shift buffer)."""
    jm, params, tm = _pair()
    srv = DecodeServer(tm, n_slots=2, max_text_len=10, chunk=4)
    reqs = [([5, 9, 3, 17], np.array([[7, 8, 9]]), 13), ([12, 4, 33, 7, 19], None, 10),
            ([40, 41, 42], np.array([[3, 4]]), 9)]
    rids = [srv.submit(np.asarray(t), prompt=p, max_len=n) for t, p, n in reqs]
    done = {c.rid: c for c in srv.run()}
    assert set(done) == set(rids)
    for rid, (text, prompt, max_len) in zip(rids, reqs):
        ref = jax_generate(jm, params, jnp.asarray([text]), jax.random.PRNGKey(0),
                           prompt=None if prompt is None else jnp.asarray(prompt)[:, None],
                           max_seqlen=max_len, k=1, force_max_seqlen=True)
        toks = np.asarray(ref.tokens)[:, 0].T
        np.testing.assert_array_equal(done[rid].tokens, toks[:done[rid].length])


def test_rwkv6_has_no_lazy_window_no_int8_state_and_no_s0_tuning():
    """As in the JAX package: lazy decode (and so int8 states) raises
    TypeError for RWKV6 states, in generate_batch and in the server; int8
    states without a lazy window raise ValueError; initial-state tuning
    takes the AttentiveGLA backbones only; a layer step refuses a window
    position."""
    from lina_speech_tpu_torch.train.initial_state import train_initial_state

    _, _, tm = _pair()
    x = torch.randint(3, 256, (1, 5), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="RWKV6State"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2)
    with pytest.raises(TypeError, match="RWKV6State"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2, state_quant="int8")
    with pytest.raises(ValueError, match="lazy_window"):
        generate_batch(tm, x, max_seqlen=6, k=1, state_quant="int8")
    with pytest.raises(TypeError, match="RWKV6State"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, lazy=True)
    with pytest.raises(TypeError, match="RWKV6State"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, lazy=True, state_quant="int8")
    with pytest.raises(TypeError, match="AttentiveGLA"):
        train_initial_state(tm, [])
    layer = tm.attentive_rnn.encoder[0].tmix
    with pytest.raises(TypeError, match="RWKV6State"):
        layer.step(torch.zeros(1, 64), layer.empty_state(1), lazy_p=0)


def test_kernel_modes():
    """kernel_mode "scan" takes the O(T) recurrence for the prefill and
    agrees with "chunk"; modes the port has not raise."""
    from unittest import mock

    from lina_speech_tpu_torch.models import rwkv6 as rwkv6_model

    _, _, tm = _pair()
    layer = tm.attentive_rnn.encoder[1].tmix
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 11, 64)).astype(np.float32))
    with torch.no_grad():
        ref = layer(x)
        layer.kernel_mode = "scan"
        try:
            with mock.patch.object(rwkv6_model, "rwkv6_scan_ref",
                                   wraps=rwkv6_model.rwkv6_scan_ref) as scan:
                got = layer(x)
        finally:
            layer.kernel_mode = "auto"
    assert scan.call_count == 1
    _close(got, ref.numpy(), 1e-5)
    with pytest.raises(NotImplementedError):
        RWKV6Attention(64, 2, kernel_mode="chunk_pallas")
