"""The chunked decomposition of the RWKV6 forward, on the CPU.

``rwkv6_chunk_chunked_plain`` (ops/rwkv6_cuda.py) is the chunked route of
the CUDA forward written with tensors: the GLA forward's chunk walk
(``gla_cuda._chunked_fwd_plain``) with r in u's place, the readout decayed
at the exclusive gate sum and the bonus u on the diagonal; chunk states with
the decayed key in two rounded parts, every product operand rounded to the
IO dtype. Here o and the final state are held against
``rwkv6_chunk_pallas`` in interpret mode on the same inputs, made with numpy
from a seed: within 1e-4 of max(1, max|ref|) for f32 IO (summation order),
and within 2e-2 of max|ref| for bf16 IO (both sides round their products'
operands to bf16, at other points: the Pallas kernel's dyadic levels and its
one-part decayed key).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lina_speech_tpu.ops.rwkv6_pallas import rwkv6_chunk_pallas
from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda
from lina_speech_tpu_torch.ops.rwkv6 import rwkv6_scan_ref

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: 1e-4, BF16: 2e-2}
LEAVES = ("r", "k", "v", "w", "u")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, t, io, st, b=2, h=2, dk=16, dv=32, adversarial=False):
    """r, k, v in ``io``; f32 log-decays -exp(N(-2, 0.5)) as a trained
    layer's, f32 bonus u; an initial state of dtype ``st`` (None: none).
    ``adversarial``: every sixth key channel decays by 6 to 8 a step (a
    64-row chunk's gate sum there falls below -384, so e^{-b} would overflow
    f32) and 5% of the steps reset with -20, as a packed batch's segment
    starts do (models/rwkv6.py). Values are drawn in f32 and rounded to
    their dtype once, so both frameworks see the same numbers."""
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.normal(size=(b, h, t, dk)) * 0.5 - 2.0)
    if adversarial:
        w[..., ::6] = -6.0 - 2.0 * rng.random(size=w[..., ::6].shape)
        w = np.where(rng.random(size=(b, 1, t, 1)) < 0.05, -20.0, w)
    x = dict(r=rng.normal(size=(b, h, t, dk)), k=rng.normal(size=(b, h, t, dk)),
             v=rng.normal(size=(b, h, t, dv)), w=w, u=rng.normal(size=(h, dk)) * 0.5,
             s0=rng.normal(size=(b, h, dk, dv)))
    x = {n: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for n, a in x.items()}
    for n in ("r", "k", "v"):
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
    for what, a, r in zip(("o", "final state"), got, ref):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        a = a.float().numpy()
        assert a.shape == r.shape, (name, what)
        assert np.isfinite(a).all(), (name, what)
        ref_max = float(np.abs(r).max())
        assert ref_max > 0, (name, what)
        err = float(np.abs(a - r).max())
        limit = TOL[io] * (max(1.0, ref_max) if io == F32 else ref_max)
        assert err <= limit, (name, what, err, limit)


# (t, IO dtype, initial-state dtype or None, adversarial gates): every t of
# 1, 5, 64, 65 and 130 (ragged chunks and sub-chunks) in each IO dtype, every
# initial state in each IO dtype, adversarial gates in both
CASES = [(1, F32, None, False), (5, F32, F32, False), (64, F32, BF16, False),
         (65, F32, None, True), (130, F32, F32, True),
         (1, BF16, BF16, False), (5, BF16, None, False), (64, BF16, F32, False),
         (65, BF16, BF16, True), (130, BF16, None, True)]


@pytest.mark.parametrize("t,io,st,adversarial", CASES, ids=str)
def test_chunked_forward_matches_pallas(t, io, st, adversarial):
    x = _inputs(30 + t, t, io, st, adversarial=adversarial)
    args = [x[n] for n in LEAVES]
    got = rwkv6_cuda.rwkv6_chunk_chunked_plain(*args, initial_state=x["s0"])
    assert got[0].dtype == io and got[1].dtype == (st or F32)
    ref = rwkv6_chunk_pallas(*map(_jax, args), initial_state=_jax(x["s0"]), chunk_size=64,
                             interpret=True)
    _hold(got, ref, io, "rwkv6_chunk")


@pytest.mark.parametrize("st", [None, F32])
def test_chunked_forward_matches_the_scan_under_adversarial_gates(st):
    """The same decomposition against the O(T) scan in f32 (no Pallas):
    ragged t 130 with decays of 6-8 a step and -20 resets, every exponent
    <= 0 through the 16-row split (no inf, no NaN)."""
    x = _inputs(7, 130, F32, st, adversarial=True)
    args = [x[n] for n in LEAVES]
    got = rwkv6_cuda.rwkv6_chunk_chunked_plain(*args, initial_state=x["s0"])
    ref = rwkv6_scan_ref(*args, initial_state=x["s0"])
    _hold(got, ref, F32, "rwkv6_chunk")


def test_two_part_key_keeps_an_f32_final_state():
    """bf16 IO with an f32 state over 320 steps: the decayed key enters the
    state update as two bf16 parts, so the final state stays within 1e-4 of
    max|S| of the f32 scan (ops/rwkv6.py:rwkv6_scan_ref); o, whose operands
    are rounded once, stays within 2e-2 of max|o|."""
    x = _inputs(3, 320, BF16, F32, dk=64, dv=64)
    args = [x[n] for n in LEAVES]
    o, sf = rwkv6_cuda.rwkv6_chunk_chunked_plain(*args, initial_state=x["s0"])
    o_ref, sf_ref = rwkv6_scan_ref(*args, initial_state=x["s0"])
    assert float((sf - sf_ref).abs().max()) <= 1e-4 * float(sf_ref.abs().max())
    assert float((o.float() - o_ref.float()).abs().max()) <= 2e-2 * float(
        o_ref.float().abs().max())


# the shapes the driven paths launch rwkv6_chunk on at the flagship's RWKV6
# heads (h4 dk256 dv256): generate's prefill (b8 t151), the server's prefill
# chunks at b1 and the training forward at b8 (audio 128-512, so t up to
# 512), and the sweep's points around the thresholds
@pytest.mark.parametrize("b,t", [(8, 151), (8, 512), (8, 317), (8, 128), (8, 96), (8, 64),
                                 (1, 128), (1, 96), (1, 64), (1, 32), (1, 1), (2, 96), (2, 64),
                                 (4, 96), (4, 128)])
def test_forward_plan_routes_by_io_dtype_and_length(b, t):
    """f32 IO takes the recurrent body at every shape; bf16 IO the chunked
    route from the measured crossover on (96 tokens, 128 above 8 heads in
    flight), the recurrent body below it."""
    h, dv = 4, 256
    assert rwkv6_cuda.rwkv6_chunk_fwd_plan(F32, b, h, t, dv) == "recurrent"
    want = "chunked" if t >= (128 if b * h > 8 else 96) else "recurrent"
    assert rwkv6_cuda.rwkv6_chunk_fwd_plan(BF16, b, h, t, dv) == want


@pytest.mark.parametrize("b,t,split", [(8, 512, 1), (8, 151, 2), (1, 128, 4)])
def test_chunked_forward_scratch_at_the_driven_shapes(b, t, split):
    """The chunked route's scratch at the flagship RWKV6 heads on an H100
    (132 SMs): the GLA forward's ten arrays, r in q's place, the bonus read
    from u itself. The training forward (b8 t512) forms its score matrices
    in the output kernel (split 1: no parts); generate's prefill (b8 t151)
    and a server chunk (b1 t128) spread the value tiles and sum A from the
    key tiles' parts."""
    h, dk, dv = 4, 256, 256
    assert gla_cuda.fwd_out_split(b, h, t, dv, 132) == split
    sizes = gla_cuda._chunked_fwd_sizes(b, h, t, dk, dv, split)
    tp = -(-t // 64) * 64
    assert sizes[:3] == [4 * b * h * tp * dk] * 3  # r, k and the gate sums in f32
    assert sizes[6] == 2 * b * h * (tp // 64) * dk * dv  # the chunk states in bf16
    assert (sizes[9] > 0) == (split > 1)
    if (b, t) == (8, 512):
        assert sizes[6] == 33_554_432


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_route():
    """On CPU tensors rwkv6_chunk runs its plain version and counts neither a
    launch nor a route; reset_launch_counts clears the routes and the
    shapes' launch counts."""
    x = _inputs(2, 70, BF16, F32)
    args = [x[n] for n in LEAVES]
    rwkv6_cuda.rwkv6_chunk.routes["chunked"] = 3
    rwkv6_cuda.reset_launch_counts()
    assert rwkv6_cuda.rwkv6_chunk.routes == {"recurrent": 0, "chunked": 0}
    o, sf = rwkv6_cuda.rwkv6_chunk(*args, initial_state=x["s0"])
    op, sp = rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])
    assert torch.equal(o, op) and torch.equal(sf, sp)
    assert rwkv6_cuda.rwkv6_chunk.routes == {"recurrent": 0, "chunked": 0}
    assert rwkv6_cuda.launch_shape_counts() == {"rwkv6_chunk": {}, "rwkv6_chunk_bwd": {},
                                                "rwkv6_decode": {}}
    assert rwkv6_cuda.launch_shapes()["rwkv6_chunk"] == set()
