"""The port's Mamba (v1) backbone vs the JAX package, on the CPU.

The ops first: the port's plain ``selective_scan`` (and the ``mamba_scan``
wrapper, which takes it on CPU tensors) against the JAX package's
``selective_scan`` and its Pallas kernel ``mamba_scan_pallas`` run in
interpret mode, as tests/test_mamba_pallas.py runs it: with and without an
initial state and with a reset mask, in f32 within rtol = atol = 2e-4 (that
file's tolerance: the associative scan and the loop sum in other orders);
bf16 IO; the gradients of x, dt, A, B, C, D and s0 of autograd through the
plain loop against the Pallas kernel's hand-written VJP within 2e-3 of
max(|ref|, 1) (tests/test_mamba_pallas.py:63-65); ``selective_step``.

Then the mixer, on weights carried by ``utils/convert.py``: forward and
final state from a state, the conv-history continuation, ``step`` and a
tail shorter than d_conv; and the backbones, ``lina_gla_tiny`` with
``kind="mamba"`` (blind) and interleaved with ``cross_att_layers=(1,)``,
initialized by JAX with ``A_log``, ``D`` and ``dt_proj``'s bias moved off
their constant inits with numpy from a seed. Both sides compute in f32 and
differ in summation order only: outputs within 1e-4 of their own max
(3e-4 where a decode loop or a chunked prefill is held against a one-shot
prefill, as tests/test_variants.py does), gradients within 1e-4 of each
leaf's max (plus 1e-7 for leaves that are zero in exact arithmetic, such as
the attention's key bias); greedy tokens token for token.
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
from lina_speech_tpu.models.mamba import MambaMixer as JaxMixer
from lina_speech_tpu.models.mamba import MambaState as JaxState
from lina_speech_tpu.ops import mamba as jax_ops
from lina_speech_tpu.ops.mamba_pallas import mamba_scan_pallas
from lina_speech_tpu.train import harness as jharness
from lina_speech_tpu_torch.config import build_model as torch_build
from lina_speech_tpu_torch.config import lina_gla_tiny as torch_tiny
from lina_speech_tpu_torch.data import synthetic
from lina_speech_tpu_torch.generate import generate_batch
from lina_speech_tpu_torch.models.mamba import (
    AttentiveMamba, CrossAttMamba, MambaMixer, MambaState,
)
from lina_speech_tpu_torch.ops import mamba as ops
from lina_speech_tpu_torch.ops import mamba_cuda
from lina_speech_tpu_torch.serving import DecodeServer
from lina_speech_tpu_torch.train import harness
from lina_speech_tpu_torch.utils.convert import (
    backbone_state_from_arrays, backbone_state_to_arrays, jax_params_to_state_dict,
    load_jax_params, named_tensors_to_jax,
)
from test_torch_model import _train_batch

TOL_OP = 2e-4
TOL = 1e-4
TOL_LOOP = 3e-4
NAMES = ("x", "dt", "A", "B", "C", "D", "s0")


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


def _allclose(t, j, tol=TOL_OP):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------------- ops
def _op_inputs(seed, b=2, t=37, d=24, n=16, s0=True, reset=False):
    """x, dt, A, B, C, D, s0 and a reset mask as numpy arrays, spread as
    tests/test_mamba_pallas.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = dict(x=f(b, t, d), dt=np.log1p(np.exp(f(b, t, d) - 1.0)).astype(np.float32),
               A=-np.exp(f(d, n) * 0.3).astype(np.float32), B=f(b, t, n), C=f(b, t, n),
               D=f(d), s0=f(b, d, n) if s0 else None, reset=None)
    if reset:
        out["reset"] = rng.random((b, t)) < 0.1
        out["reset"][:, t // 3] = True
    return out


def _jax_args(x, dtype=np.float32):
    cast = lambda n: jnp.asarray(x[n], dtype if n in ("x", "B", "C") else np.float32)
    return [cast(n) for n in NAMES[:6]]


def _torch_args(x, dtype=torch.float32):
    cast = lambda n: torch.from_numpy(x[n]).to(dtype if n in ("x", "B", "C") else torch.float32)
    return [cast(n) for n in NAMES[:6]]


def _opt(x, name, lib):
    v = x[name]
    return None if v is None else (jnp.asarray(v) if lib == "jax" else torch.from_numpy(v))


@pytest.mark.parametrize("t,s0,reset", [(37, True, False), (32, False, True), (5, True, True)])
def test_selective_scan_matches_jax_and_the_pallas_kernel(t, s0, reset):
    """The port's plain scan, and the wrapper on CPU tensors, against JAX's
    selective_scan (the associative scan) and mamba_scan_pallas in
    interpret mode: y and the final state (f32 with or without s0)."""
    x = _op_inputs(t, t=t, s0=s0, reset=reset)
    jkw = dict(initial_state=_opt(x, "s0", "jax"), reset_mask=_opt(x, "reset", "jax"))
    tkw = dict(initial_state=_opt(x, "s0", "torch"), reset_mask=_opt(x, "reset", "torch"))
    refs = [jax_ops.selective_scan(*_jax_args(x), mode="scan", **jkw),
            mamba_scan_pallas(*_jax_args(x), interpret=True, **jkw)]
    for got in (ops.selective_scan(*_torch_args(x), **tkw),
                mamba_cuda.mamba_scan(*_torch_args(x), **tkw)):
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
        for ref in refs:
            _allclose(got[0], ref[0])
            _allclose(got[1], ref[1])


def test_bf16_io_keeps_jax_rounding_points():
    """bf16 x, B and C: the math is f32 on both sides and y is rounded to
    bf16 once, at the end, so y agrees within one bf16 step of its own max
    and the f32 final state within 2e-4; a bf16 initial state comes back in
    bf16."""
    x = _op_inputs(3, t=32)
    for s0_dtype in (torch.float32, torch.bfloat16):
        js0 = jnp.asarray(x["s0"]).astype(jnp.float32 if s0_dtype == torch.float32
                                          else jnp.bfloat16)
        ref = jax_ops.selective_scan(*_jax_args(x, jnp.bfloat16), initial_state=js0, mode="scan")
        got = ops.selective_scan(*_torch_args(x, torch.bfloat16),
                                 initial_state=torch.from_numpy(x["s0"]).to(s0_dtype))
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == s0_dtype
        _close(got[0], np.asarray(ref[0], np.float32), 2 ** -8)
        tol = TOL_OP if s0_dtype == torch.float32 else 2 ** -8
        _close(got[1], np.asarray(ref[1], np.float32), tol)


def test_gradients_match_jax_handwritten_vjp():
    """Autograd through the port's plain loop (the backward the CPU trains
    with, and what the CUDA backward is held against on the card) against
    jax.grad through mamba_scan_pallas in interpret mode, whose VJP is the
    hand-written _bwd_kernel: x, dt, A, B, C, D and s0 with a reset mask and
    random cotangents, within 2e-3 of max(|ref|, 1)."""
    x = _op_inputs(5, t=35, d=12, reset=True)
    rng = np.random.default_rng(6)
    dy = rng.standard_normal(x["x"].shape).astype(np.float32)
    dsf = rng.standard_normal(x["s0"].shape).astype(np.float32)
    reset = jnp.asarray(x["reset"])

    def jloss(*a):
        y, s = mamba_scan_pallas(*a[:6], initial_state=a[6], reset_mask=reset, interpret=True)
        return jnp.sum(y * dy) + jnp.sum(s * dsf)

    jgrads = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(x[n]) for n in NAMES))
    leaves = [torch.from_numpy(x[n]).requires_grad_(True) for n in NAMES]
    y, s = ops.selective_scan(*leaves[:6], initial_state=leaves[6],
                              reset_mask=torch.from_numpy(x["reset"]))
    loss = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(dsf)).sum()
    for name, g, j in zip(NAMES, torch.autograd.grad(loss, leaves), jgrads):
        j = np.asarray(j)
        scale = max(float(np.abs(j).max()), 1.0)
        assert g.shape == j.shape, name
        np.testing.assert_allclose(g.numpy() / scale, j / scale, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_selective_step_matches_jax(state_dtype):
    """One token from a state; the state keeps its dtype."""
    x = _op_inputs(11, t=1)
    tok = lambda a, n: a[n][:, 0] if n in ("x", "dt", "B", "C") else a[n]
    jdt = jnp.float32 if state_dtype == torch.float32 else jnp.bfloat16
    jy, js = jax_ops.selective_step(*(jnp.asarray(tok(x, n)) for n in NAMES[:6]),
                                    jnp.asarray(x["s0"]).astype(jdt))
    ty, ts = ops.selective_step(*(torch.from_numpy(tok(x, n)) for n in NAMES[:6]),
                                torch.from_numpy(x["s0"]).to(state_dtype))
    assert ts.dtype == state_dtype
    tol = TOL_OP if state_dtype == torch.float32 else 2 ** -8
    _close(ty, jy, tol)
    _close(ts, np.asarray(js, np.float32), tol)


def test_wrappers_on_the_cpu_take_the_plain_versions_and_count_nothing():
    """On CPU tensors the forward wrapper runs its plain version and counts
    no launch; the backward wrapper runs on CUDA tensors only.
    kernel_takes: state size 16, channels a multiple of 32, f32 or bf16 IO,
    an f32 state."""
    x = _op_inputs(8, t=9, d=32)
    args = _torch_args(x)
    s0 = torch.from_numpy(x["s0"])
    mamba_cuda.reset_launch_counts()
    y, s = mamba_cuda.mamba_scan(*args, initial_state=s0)
    yp, sp = mamba_cuda.mamba_scan_plain(*args, initial_state=s0)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    assert mamba_cuda.launch_counts() == {"mamba_scan": 0, "mamba_scan_bwd": 0}
    assert all(not v for v in mamba_cuda.launch_shapes().values())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mamba_cuda.mamba_scan_bwd(*args, s0, None, torch.zeros_like(args[0]), torch.zeros_like(s0))
    assert mamba_cuda.kernel_takes(2048, 16, torch.bfloat16, torch.float32)
    assert mamba_cuda.kernel_takes(128, 16, torch.float32, torch.float32)
    assert not mamba_cuda.kernel_takes(2048, 8, torch.bfloat16, torch.float32)
    assert not mamba_cuda.kernel_takes(24, 16, torch.float32, torch.float32)
    assert not mamba_cuda.kernel_takes(2048, 16, torch.bfloat16, torch.bfloat16)


# ------------------------------------------------------------------ mixer
def _draw_consts(flat, rng):
    """A_log = log U(1, 16), D ~ U(0.5, 1.5) and dt_proj's bias the inverse
    softplus of a step log-uniform in [1e-3, 1e-1], for every Mamba mixer
    in ``flat`` (slash-joined paths); returns how many leaves were drawn."""
    hit = 0
    for path, val in flat.items():
        if path.endswith("/A_log"):
            new = np.log(1.0 + 15.0 * rng.random(val.shape))
        elif path.endswith("/D") and val.ndim == 1:
            new = 0.5 + rng.random(val.shape)
        elif path.endswith("dt_proj/bias"):
            dt = np.exp(np.log(1e-3) + rng.random(val.shape) * np.log(100.0))
            new = dt + np.log(-np.expm1(-dt))
        else:
            continue
        flat[path] = new.astype(np.float32)
        hit += 1
    return hit


_MIXER = {}


def _mixer_pair():
    """(JAX MambaMixer, its params, the port's mixer with the same weights),
    d_model 32 (d_inner 64, dt_rank 2)."""
    if not _MIXER:
        jm = JaxMixer(d_model=32)
        params = jm.init(jax.random.PRNGKey(1), jnp.ones((1, 4, 32)))
        flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, params), sep="/")
        assert _draw_consts(flat, np.random.default_rng(2)) == 3
        params = traverse_util.unflatten_dict(flat, sep="/")
        prefix = "attentive_rnn/encoder_0/tmix/"
        sd = jax_params_to_state_dict({prefix + k[len("params/"):]: v for k, v in flat.items()})
        tm = MambaMixer(32)
        tm.load_state_dict({k[len("attentive_rnn.encoder.0.tmix."):]: v for k, v in sd.items()},
                           strict=True)
        _MIXER["pair"] = (jm, params, tm)
    return _MIXER["pair"]


def _mixer_state(seed, b=2, d_inner=64, n=16, w=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d_inner, n)).astype(np.float32),
            rng.standard_normal((w, b, d_inner)).astype(np.float32))


def _mixer_x(seed, t, b=2):
    return np.random.default_rng(seed).standard_normal((b, t, 32)).astype(np.float32)


@pytest.mark.parametrize("t", [11, 2], ids=["t11", "tail-shorter-than-d_conv"])
def test_mixer_forward_and_state_match_jax(t):
    """The mixer's forward from a carried state with a reset mask (y, h and
    the conv ring), and from no state on a chunk shorter than d_conv (the
    ring's front is zero-padded), against the JAX mixer."""
    jm, params, tm = _mixer_pair()
    x = _mixer_x(t, t)
    h, conv = _mixer_state(t)
    reset = np.zeros((2, t), bool)
    reset[0, t // 2] = True
    from_state = t > tm.d_conv
    jst = JaxState(h=jnp.asarray(h), conv=jnp.asarray(conv)) if from_state else None
    tst = MambaState(h=torch.from_numpy(h), conv=torch.from_numpy(conv)) if from_state else None
    jy, jfin = jm.apply(params, jnp.asarray(x), reset_mask=jnp.asarray(reset),
                        initial_state=jst, output_final_state=True)
    with torch.no_grad():
        ty, tfin = tm(torch.from_numpy(x), initial_state=tst, output_final_state=True,
                      reset_mask=torch.from_numpy(reset))
    _close(ty, jy, TOL)
    _close(tfin.h, jfin.h, TOL)
    _close(tfin.conv, jfin.conv, TOL)
    if not from_state:  # the ring holds the 2 inputs behind 2 zero rows
        assert tfin.conv.shape == (4, 2, 64) and not bool(tfin.conv[:2].any())


def test_mixer_conv_history_and_step_match_jax():
    """A chunk that continues a stream from the carried conv ring
    (conv_history) equals the one-shot forward and JAX's continuation; one
    decode step (the plain selective_step) from that state against JAX's."""
    jm, params, tm = _mixer_pair()
    x = _mixer_x(5, 9)
    h, conv = _mixer_state(5)
    jst = JaxState(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tst = MambaState(h=torch.from_numpy(h), conv=torch.from_numpy(conv))

    def jchunks(m, x, st):
        ys = []
        for i, (a, b) in enumerate(((0, 6), (6, 8), (8, 9))):
            y, st = m(x[:, a:b], initial_state=st, output_final_state=True, conv_history=i > 0)
            ys.append(y)
        y_t, st_t = m.step(x[:, -1] * 0.5, st)
        return jnp.concatenate(ys, 1), st, y_t, st_t

    jy, jfin, jy_t, jst_t = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=jchunks))(
        params, jnp.asarray(x), jst)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        one, one_st = tm(xt, initial_state=tst, output_final_state=True)
        st, ys = tst, []
        for i, (a, b) in enumerate(((0, 6), (6, 8), (8, 9))):
            y, st = tm(xt[:, a:b], initial_state=st, output_final_state=True,
                       conv_history=i > 0)
            ys.append(y)
        y_t, st_t = tm.step(xt[:, -1] * 0.5, st)
    chunked = torch.cat(ys, 1)
    _close(chunked, jy, TOL)
    _close(chunked, one.numpy(), TOL_LOOP)
    for got, ref in ((st.h, jfin.h), (st.conv, jfin.conv), (st_t.h, jst_t.h),
                     (st_t.conv, jst_t.conv), (y_t, jy_t)):
        _close(got, ref, TOL)
    _close(st.h, one_st.h.numpy(), TOL_LOOP)
    assert torch.equal(st.conv, one_st.conv)
    with pytest.raises(ValueError, match="conv_history"):
        tm(xt, conv_history=True)


# ------------------------------------------------------------------ models
BACKBONES = {"blind": dict(kind="mamba"),
             "interleaved": dict(kind="mamba", cross_att_layers=(1,), blind=False)}
_PAIRS = {}


def _cfg(base, name, **top):
    return dataclasses.replace(base, backbone=dataclasses.replace(
        base.backbone, **BACKBONES[name]), **top)


def _pair(name):
    """(jax model, jax params with the constants drawn, port model with the
    same weights), once per backbone and module."""
    if name not in _PAIRS:
        jm = jax_build(_cfg(lina_gla_tiny(), name))
        b, m, n = 2, 7, 9
        params = jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.ones((b, m), jnp.int32), jnp.ones((b, n, 1), jnp.int32),
            jnp.ones((b, m, m), bool), jnp.ones((b, n, m), bool), jnp.ones((b, n), bool))
        flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, params), sep="/")
        n_mixers = 5 if name == "blind" else 2  # 2 + 2 blocks and the pos_net; 2 blocks
        assert _draw_consts(flat, np.random.default_rng(0)) == 3 * n_mixers
        params = traverse_util.unflatten_dict(flat, sep="/")
        tm = load_jax_params(torch_build(_cfg(torch_tiny(), name), device="cpu"), params)
        _PAIRS[name] = (jm, params, tm.eval())
    return _PAIRS[name]


def _jax_state_arrays(state):
    out = {}
    named = [(f"layers/{i}", st) for i, st in enumerate(state.layers)]
    named.append(("pos_net", state.pos_net))
    for prefix, st in named:
        if st is not None:
            for f in dataclasses.fields(st):
                out[f"{prefix}/{f.name}"] = np.asarray(getattr(st, f.name), np.float32)
    return out


def _hold_states(got, ref, tol):
    got, ref = backbone_state_to_arrays(got), _jax_state_arrays(ref)
    assert set(got) == set(ref) and all(k.endswith(("/h", "/conv")) for k in ref)
    for key in ref:
        _close(got[key], ref[key], tol)


def _text_codes(seed, n=10):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=(2, 7)), rng.integers(3, 53, size=(1, 2, n))


@pytest.mark.parametrize("name", list(BACKBONES))
def test_build_matches_jax_parameter_for_parameter(name):
    """build_model(kind="mamba") builds the JAX structure, blind and
    interleaved: every JAX param has its port parameter of the same shape
    and values after loading (A_log, D and the conv taps untransposed, the
    four Dense kernels transposed and back); the port's own init gives
    A_log = log(1 .. 16) in every channel, as JAX's."""
    _, params, tm = _pair(name)
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    got = named_tensors_to_jax(tm.named_parameters())
    assert set(got) == set(flat)
    for path, val in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(val), err_msg=path)
    own = torch_build(_cfg(torch_tiny(), name), device="cpu")
    cls = AttentiveMamba if name == "blind" else CrossAttMamba
    assert isinstance(own.attentive_rnn, cls)
    mixer = own.attentive_rnn.blocks[0].tmix if name != "blind" else \
        own.attentive_rnn.encoder[0].tmix
    assert isinstance(mixer, MambaMixer) and mixer.dt_rank == 4
    np.testing.assert_allclose(mixer.A_log.detach().numpy(),
                               np.broadcast_to(np.log(np.arange(1, 17)), (128, 16)), rtol=1e-6)
    assert bool((mixer.D == 1).all()) and not bool(mixer.dt_proj.bias.any())


@pytest.mark.parametrize("name", list(BACKBONES))
def test_forward_logits_loss_and_gradients_match_jax(name):
    """The training forward with a logits_mask (blind: a packed batch, whose
    reset_mask zeroes the scan's decay at each segment start, and
    crossatt_pos; interleaved: a padded batch): logits and loss, and the
    gradient of every parameter by name against jax.value_and_grad."""
    jm, params, tm = _pair(name)
    packed = name == "blind"
    batch = _train_batch("packed" if packed else "padded")
    keys = ("text_token", "audio_token", "encoder_mask", "crossatt_mask")
    extra = ("reset_mask", "crossatt_pos") if packed else ()

    def loss_fn(p):
        logits, loss, _ = jm.apply(p, *(jnp.asarray(batch[k]) for k in keys),
                                   logits_mask=jnp.asarray(batch["y_mask"]),
                                   **{k: jnp.asarray(batch[k]) for k in extra})
        return loss, logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tm.zero_grad(set_to_none=True)
    logits, loss, _ = tm(*(tb[k] for k in keys), logits_mask=tb["y_mask"],
                         **{k: tb[k] for k in extra})
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


@pytest.mark.parametrize("name", list(BACKBONES))
def test_prefill_decode_and_states_match_jax(name):
    """Prefill logits and final states (h and conv of every mixer) against
    the JAX prefill; one decode step from that state against JAX's; the
    port's token-by-token decode from an empty state against its own
    prefill; the JAX state crosses into the port and steps the same."""
    jm, params, tm = _pair(name)
    text, codes = _text_codes(6)

    def jrun(m, text, codes):
        x_enc = m.encode_text(text)
        y = m.embed_tokens(codes)
        logits, _, st = m.prefill(y[:, :-1], x_enc, m.empty_state(text.shape[0]))
        logits_t, _, st_t = m.decode_step(y[:, -1], x_enc, st, time_step=9)
        return logits, st, logits_t, st_t

    jl, jst, jl_t, jst_t = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=jrun))(
        params, jnp.asarray(text), jnp.asarray(codes))
    with torch.no_grad():
        x_enc = tm.encode_text(torch.from_numpy(text))
        y = tm.embed_tokens(torch.from_numpy(codes))
        empty = tm.empty_state(2)
        assert isinstance(empty.layers[0], MambaState) and empty.layers[0].h.shape == (2, 128, 16)
        tl, _, st = tm.prefill(y[:, :-1], x_enc, empty)
        _close(tl, jl, TOL)
        _hold_states(st, jst, TOL)
        tl_t, _, st_t = tm.decode_step(y[:, -1], x_enc, st, time_step=9)
        _close(tl_t, jl_t, TOL)
        _hold_states(st_t, jst_t, TOL)
        tl_j, _, _ = tm.decode_step(y[:, -1], x_enc, backbone_state_from_arrays(jst), time_step=9)
        _close(tl_j, jl_t, TOL)
        full, _, st_full = tm.prefill(y, x_enc, tm.empty_state(2))
        st, steps = tm.empty_state(2), []
        for t in range(y.shape[1]):
            lg, _, st = tm.decode_step(y[:, t], x_enc, st, time_step=t)
            steps.append(lg)
    _close(torch.stack(steps, 1), full.numpy(), TOL_LOOP)
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL_LOOP, atol=TOL_LOOP)


@pytest.mark.parametrize("name", list(BACKBONES))
def test_chunked_prefill_matches_one_shot_and_jax(name):
    """A prefill as [8, 4, 1] chunks (conv_history and time_offset from the
    second on) equals the one-shot prefill, logits and final state, and the
    JAX package run over the same chunks."""
    jm, params, tm = _pair(name)
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

    jl, jst = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=jrun))(
        params, jnp.asarray(text), jnp.asarray(codes))
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
    _close(chunked, full.numpy(), TOL_LOOP)
    _hold_states(st, jst, TOL)
    for a, b in zip(backbone_state_to_arrays(st).values(),
                    backbone_state_to_arrays(st_full).values()):
        np.testing.assert_allclose(a, b, rtol=TOL_LOOP, atol=TOL_LOOP)


@pytest.mark.parametrize("name,quant", [("blind", False), ("blind", True),
                                        ("interleaved", False)])
def test_greedy_generate_matches_jax(name, quant):
    """Greedy generate_batch with a prompt (classic token loop), token for
    token against the JAX package; with ``weight_quant="int8"`` the mixers'
    four Linears (in_proj, x_proj, dt_proj, out_proj) run on int8 copies on
    both sides, as JAX's QDense."""
    jm, params, tm = _pair(name)
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
        mixer = tm.attentive_rnn.encoder[0].tmix
        assert all(getattr(mixer, n).int8_q is not None
                   for n in ("in_proj", "x_proj", "dt_proj", "out_proj"))


def test_classic_server_matches_jax_generate():
    """DecodeServer in classic mode, two slots recycled by three requests:
    each completion equals the JAX package's greedy generate_batch of that
    request, token for token (the slot machinery finds the batch axis of h
    and of the time-major conv ring)."""
    jm, params, tm = _pair("blind")
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


def test_train_step_matches_jax():
    """One optimizer step of make_train_step on the blind backbone against
    the JAX step: loss, grad_norm and acc_0 within 1e-4 relative, and every
    parameter after the step within 1e-4 of its own max|ref| plus 1e-3 of
    the learning rate (tests/test_torch_train.py's bound; elements whose
    gradient is zero in exact arithmetic, the attention's key biases, to the
    learning rate)."""
    jm, params, tm = _pair("blind")
    cfg = dict(learning_rate=5e-4, n_warmup_steps=1, n_training_steps=10)
    lr = 5e-4
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batch = next(synthetic.synthetic_tts_batches(
        batch_size=2, n_quant=1, n_codebook=50, min_audio_len=8, max_audio_len=14,
        pad_to_multiple=8, seed=0, structured=True))
    jstate = jharness.create_train_state(jm, params, jharness.TrainConfig(**cfg))
    jstate, jmet = jharness.make_train_step(jm, donate=False)(jstate, batch,
                                                              jax.random.PRNGKey(0))
    tstate = harness.create_train_state(tm, harness.TrainConfig(**cfg))
    try:
        tstate, tmet = harness.make_train_step(tm)(tstate, harness.batch_to_device(batch, "cpu"))
        for k in ("loss", "grad_norm", "acc_0"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
        got = named_tensors_to_jax(tm.named_parameters())
        ref = traverse_util.flatten_dict(jstate.params["params"], sep="/")
        assert set(got) == set(ref)
        for path, r in ref.items():
            r = np.asarray(r, np.float32)
            err = np.abs(got[path] - r)
            noise = np.zeros(r.shape, bool)
            if path.endswith("ln_k/bias"):
                noise[:] = True
            elif path.endswith("qkv/bias"):
                noise[r.shape[0] // 3:2 * r.shape[0] // 3] = True
            assert float(err[noise].max(initial=0.0)) <= lr * 1.001, path
            if not noise.all():
                tol = 1e-4 * float(np.abs(r[~noise]).max()) + 1e-3 * lr
                assert float(err[~noise].max()) <= tol, (path, float(err[~noise].max()), tol)
    finally:
        tm.load_state_dict({**tm.state_dict(), **start})
        tm.eval()


def test_mamba_has_no_lazy_window_no_int8_state_and_no_s0_tuning():
    """As in the JAX package: lazy decode (and so int8 states) raises
    TypeError for Mamba states, in generate_batch and in the server; int8
    states without a lazy window raise ValueError; initial-state tuning
    takes the AttentiveGLA backbones only."""
    from lina_speech_tpu_torch.train.initial_state import train_initial_state

    _, _, tm = _pair("blind")
    x = torch.randint(3, 256, (1, 5), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="MambaState"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2)
    with pytest.raises(TypeError, match="MambaState"):
        generate_batch(tm, x, max_seqlen=6, k=1, lazy_window=2, state_quant="int8")
    with pytest.raises(ValueError, match="lazy_window"):
        generate_batch(tm, x, max_seqlen=6, k=1, state_quant="int8")
    with pytest.raises(TypeError, match="MambaState"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, lazy=True)
    with pytest.raises(TypeError, match="MambaState"):
        DecodeServer(tm, n_slots=1, max_text_len=8, chunk=2, lazy=True, state_quant="int8")
    with pytest.raises(TypeError, match="AttentiveGLA"):
        train_initial_state(tm, [])


def test_kernel_modes_reach_the_mixer():
    """set_kernel_mode reaches every Mamba mixer; "chunk" and "scan" take
    the plain scan and agree with "auto" (which takes it too on the CPU);
    modes the port has not raise."""
    from unittest import mock

    _, _, tm = _pair("interleaved")
    mixers = [m for m in tm.modules() if isinstance(m, MambaMixer)]
    layer = mixers[1]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 11, 64)).astype(np.float32))
    with torch.no_grad():
        ref = layer(x)
        tm.set_kernel_mode("chunk")
        try:
            assert all(m.kernel_mode == "chunk" for m in mixers)
            with mock.patch.object(mamba_cuda, "mamba_scan_plain",
                                   wraps=mamba_cuda.mamba_scan_plain) as plain:
                got = layer(x)
        finally:
            tm.set_kernel_mode("auto")
    assert plain.call_count == 1
    _close(got, ref.numpy(), 1e-6)
    layer.kernel_mode = "scan"
    try:
        with torch.no_grad():
            _close(layer(x), ref.numpy(), 1e-6)
    finally:
        layer.kernel_mode = "auto"
    with pytest.raises(NotImplementedError):
        MambaMixer(64, kernel_mode="chunk_pallas")
