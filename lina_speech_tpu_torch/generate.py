"""Autoregressive generation (voice cloning by prompt continuation).

Counterpart of ``lina_speech_tpu/generate.py`` (reference
modeling_lina.py:111-192): the text is encoded, the prompt is prefilled
chunk-parallel through the GLA prefill kernel, and a Python token loop runs
:meth:`LinaModel.decode_step` until every row has emitted the all-stop
token (or ``max_seqlen`` with ``force_max_seqlen``) -- token by token, or in
lazy windows (``lazy_window``). Sampling takes an
explicit ``torch.Generator``: top-k + temperature for quantizers below
``first_greedy_quant``, greedy for the rest. ``cfg_coef`` turns on
classifier-free guidance. :func:`cut_outputs` applies the reference's
per-row stop trimming.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lina_speech_tpu_torch.models.attentive_rnn import add_lazy_buffers, map_state
from lina_speech_tpu_torch.models.base_blocks import use_int8_weights
from lina_speech_tpu_torch.models.gla_layer import check_state_quant
from lina_speech_tpu_torch.models.lina import LinaModel
from lina_speech_tpu_torch.ops.sampling import topk_sampling
from lina_speech_tpu_torch.ops.tools import undelay_rvq


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # (q, b, max_seqlen) sampled (delayed) codec tokens
    stop_mask: torch.Tensor   # (b, max_seqlen) True where an all-stop was emitted
    lengths: torch.Tensor     # (b,) 1 + index of first stop (== steps generated)
    att: Optional[torch.Tensor]  # (b, max_seqlen, heads, m) or None
    n_steps: int              # decode-loop steps actually executed (incl. prefill)


def _batch_axis(b_shape, o_shape, n_slots, one: int = 1) -> int:
    """Axis where the batched leaf has ``n_slots`` and the request leaf
    has ``one`` (everything else equal; ``one=2`` under CFG, where a
    request carries a conditional and an unconditional row)."""
    b_shape, o_shape = tuple(b_shape), tuple(o_shape)
    for i, (bs, os) in enumerate(zip(b_shape, o_shape)):
        if bs == n_slots and os == one and \
                b_shape[:i] + b_shape[i + 1:] == o_shape[:i] + o_shape[i + 1:]:
            return i
    raise ValueError(f"no batch axis between {b_shape} and {o_shape}")


def _tile_state(model: LinaModel, state, b: int):
    """Every tensor of ``state`` twice along its batch axis (CFG doubles the
    batch), the axis found per leaf from the shapes of a one-row and a
    ``b``-row empty state, as the JAX package's ``_tile_state``. A clock
    the batch shares (the transformer's ``t``) stays as it is."""
    one, many = (model.empty_state(n, device="meta") for n in (1, b))

    def tile(leaf, l1, lb):
        if not torch.is_tensor(leaf):
            return leaf
        return torch.cat([leaf, leaf], dim=_batch_axis(lb.shape, l1.shape, b))

    return map_state(tile, state, one, many)


def _guide(logits: torch.Tensor, cfg_coef: Optional[float]) -> torch.Tensor:
    """Classifier-free guidance over the two halves of the batch, the
    conditional rows first: (2b, ...) -> (b, ...) ``l_u + cfg_coef (l_c -
    l_u)`` in the logits' dtype; the identity without CFG."""
    if cfg_coef is None:
        return logits
    lc, lu = logits.chunk(2, dim=0)
    return (lu + cfg_coef * (lc - lu)).to(logits.dtype)


def _tile(z: torch.Tensor, cfg_coef: Optional[float]) -> torch.Tensor:
    """The rows of ``z`` twice under CFG (conditional, then unconditional)."""
    return z if cfg_coef is None else torch.cat([z, z], dim=0)


def _sample_tokens(generator, logits, k, temp, first_greedy_quant,
                   reference_compat=False):
    """logits: (..., q, l) -> (..., q) ids; top-k for q < first_greedy_quant."""
    cols = []
    for i in range(logits.shape[-2]):
        if i < first_greedy_quant:
            cols.append(topk_sampling(generator, logits[..., i, :], k=k,
                                      temp=temp,
                                      reference_compat=reference_compat))
        else:
            cols.append(topk_sampling(generator, logits[..., i, :], k=1))
    return torch.stack(cols, dim=-1)


@torch.no_grad()
def generate_batch(
    model: LinaModel,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    prompt: Optional[torch.Tensor] = None,
    init_state=None,
    max_seqlen: int = 1000,
    k: int = 100,
    first_greedy_quant: int = 1,
    temp: float = 1.0,
    force_max_seqlen: bool = False,
    return_att: bool = False,
    reference_compat_sampling: bool = False,
    approx_topk: bool = False,
    lazy_window: int = 0,
    weight_quant: Optional[str] = None,
    quant_min_size: int = 1 << 16,
    quant_exclude=None,
    state_quant: Optional[str] = None,
    cfg_coef: Optional[float] = None,
) -> GenerateResult:
    """Generate codec tokens for a batch.

    x: (b, m) BPE text ids; prompt: optional (q, b, p) raw codec codes
    (offset by ``n_special_token_in`` here); init_state: optional
    BackboneState. ``generator`` drives top-k sampling and may be None for
    fully greedy decoding.

    ``lazy_window`` > 0 decodes in windows of that many lazy steps: the
    recurrent states are only read between folds, each token rides small
    (L, ...) window buffers, and one fold per window does the single state
    read and write -- the same recurrence. Early stop is then at window
    granularity.

    ``weight_quant="int8"`` runs the TOKEN LOOP on int8 copies of the large
    Linear weights and of the logits head (``utils/quantize.py``; kernels
    ``int8_linear`` and ``fused_ffn_int8``): decode at batch 1 reads every
    weight once per token, and int8 halves those bytes. Text encoding and
    prefill stay at full precision. The copies are made from the weights
    after the cast to the compute dtype, as the JAX package makes them.
    ``quant_min_size`` is the least element count of a weight that is
    quantized (tests lower it so that tiny configs qualify) and
    ``quant_exclude`` an optional ``fn(parameter name) -> bool`` for weights
    that stay full precision. ``state_quant="int8"`` (needs ``lazy_window``)
    keeps the read-only base states of the lazy windows int8 with one scale
    per row, requantized at every fold (kernels ``gla_decode_lazy_conv``
    with ``s_scale`` and ``gla_fold_q``). Both are opt-in quality knobs.

    ``cfg_coef`` turns on classifier-free guidance (a model trained with
    ``mask_text_p > 0``, else ``ValueError``): the batch is doubled with
    rows of the all-mask text (token ``n_txt_vocab - 1``) and every
    prediction, the prefill's and each step's, is sampled from
    ``l_uncond + cfg_coef * (l_cond - l_uncond)``. ``cfg_coef=1`` is the
    unguided run exactly; more sharpens text adherence at twice the decode
    work. A given ``init_state`` is tiled along each leaf's batch axis
    before the lazy buffers attach; ``return_att`` keeps the conditional
    rows' maps. With a ``spk_encoder`` the prompt's first embedding is
    replaced by the speaker vector pooled from the prompt embeddings.

    Still raising ``NotImplementedError``: ``state_quant="int4"`` (ROADMAP.md
    Queue 1 item 8) and ``approx_topk`` (a TPU op). Not ported from the JAX
    package on purpose: its ``sf_emit_dtype`` switch (``LINA_SF32_BUDGET_GB``), which makes the TPU prefill kernels
    emit f32 states and cast outside for a scheduling reason -- the value
    that is quantized is the state-dtype final state either way, and that is
    what the port quantizes; and the ``QLINEAR_MODE`` / ``QLINEAR_FUSED_FFN``
    environment variables -- the port reads no environment variable, w8a8
    is the ``quant_mode`` attribute of a quantized ``Linear``.

    The text is encoded with the model's own (f32) parameters; prefill and
    the token loop run on copies cast to the compute dtype, made once per
    call (the JAX package pre-casts a copy of its param tree the same way;
    norms keep f32 statistics). The caller's parameters are left as they
    were. ``lazy_window`` needs a GLA backbone (Mamba, Mamba-2 and RWKV6
    states have no lazy window: ``TypeError``, as in JAX).
    """
    if approx_topk:
        raise NotImplementedError("generate_batch(approx_topk=...) is not ported "
                                  "(a TPU op; the port samples exact top-k)")
    check_state_quant(state_quant)
    if state_quant is not None and lazy_window <= 0:
        raise ValueError("state_quant requires lazy_window > 0 (the read-only "
                         "base state is what gets quantized)")
    if weight_quant not in (None, "int8"):
        raise ValueError(f"unknown weight_quant {weight_quant!r}")
    b = x.shape[0]
    nq = model.n_quant
    stop_id = 2
    dev = x.device
    sample = lambda lg: _sample_tokens(generator, lg, k, temp,
                                       first_greedy_quant,
                                       reference_compat_sampling)

    cfg = cfg_coef is not None
    if cfg:
        if model.mask_text_p <= 0.0:
            raise ValueError("cfg_coef requires a model trained with "
                             "mask_text_p > 0 (no mask token otherwise)")
        x = torch.cat([x, torch.full_like(x, model.n_txt_vocab - 1)], dim=0)
    guide = lambda logits: _guide(logits, cfg_coef)
    tile = lambda z: _tile(z, cfg_coef)

    x_enc = model.encode_text(x)
    with model.using_params(model.cast_param_copies()):
        if weight_quant == "int8":
            model.quantize_weights_(min_size=quant_min_size, exclude=quant_exclude)
        embed = model.embed_tokens
        y_embd0 = embed(torch.ones(nq, b, 1, dtype=torch.long, device=dev))
        if init_state is None:
            init_state = model.empty_state(2 * b if cfg else b, device=dev)
        elif cfg:
            init_state = _tile_state(model, init_state, b)

        # ---- chunk-parallel prompt prefill ----
        if prompt is not None:
            prompt_in = embed(prompt.long() + model.n_special_token_in)
            if model.spk_encoder is not None:
                spk = model.spk_encoder(prompt_in).to(prompt_in.dtype)
                prompt_in = torch.cat([spk[:, None], prompt_in[:, 1:]], dim=1)
            forced = torch.cat([y_embd0, prompt_in], dim=1)  # (b, p+1, d)
        else:
            forced = y_embd0
        logits_pre, att_pre, state = model.prefill(tile(forced), x_enc, init_state,
                                                   return_att=return_att)
        logits_pre = guide(logits_pre)
        if return_att and cfg:
            att_pre = att_pre[:b]
        n_pre = forced.shape[1]
        pre_tokens = sample(logits_pre)  # (b, n_pre, q)

        # lazy mode decodes whole windows: the buffers get the overshoot room
        # and the outputs are sliced back to max_seqlen at the end
        L = lazy_window
        buf_len = max_seqlen
        if L:
            buf_len = max(n_pre + -(-max(max_seqlen - n_pre, 0) // L) * L, max_seqlen)

        tokens = torch.zeros(buf_len, b, nq, dtype=torch.long, device=dev)
        stops = torch.zeros(buf_len, b, dtype=torch.bool, device=dev)
        keep = min(n_pre, max_seqlen)
        tokens[:keep] = pre_tokens.transpose(0, 1)[:keep]
        pre_stop = (pre_tokens == stop_id).all(dim=-1)  # (b, n_pre)
        stops[:keep] = pre_stop.T[:keep]
        att_buf = None
        if return_att:
            att_buf = torch.zeros(buf_len, b, att_pre.shape[1], x_enc.shape[1],
                                  dtype=att_pre.dtype, device=dev)
            att_buf[:keep] = att_pre.permute(2, 0, 1, 3)[:keep]
        stopped = pre_stop.any(dim=1)
        y_embd = tile(embed(pre_tokens[:, -1].T[:, :, None])[:, 0])  # (b or 2b, d)

        if L:
            state = add_lazy_buffers(state, L, dtype=y_embd0.dtype, state_quant=state_quant)

        t = n_pre
        with use_int8_weights(model, on=weight_quant == "int8"):
            while t < max_seqlen and (force_max_seqlen or not bool(stopped.all())):
                # one token, or in lazy mode one window of L tokens and a fold
                for j in range(L or 1):
                    logits, att, state = model.decode_step(
                        y_embd, x_enc, state, time_step=t, lazy_p=j if L else None)
                    toks = sample(guide(logits))  # (b, q)
                    tokens[t] = toks
                    is_stop = (toks == stop_id).all(dim=-1)
                    stops[t] = is_stop
                    if return_att:
                        att_buf[t] = att[:b]
                    y_embd = tile(embed(toks.T[:, :, None])[:, 0])
                    stopped = stopped | is_stop
                    t += 1
                if L:
                    state = model.fold_lazy_state(state)

    stop_mask = stops[:max_seqlen].T  # (b, max_seqlen)
    first_stop = stop_mask.float().argmax(dim=1)
    n_steps = min(t, max_seqlen)
    lengths = torch.where(stop_mask.any(dim=1), first_stop + 1,
                          torch.full_like(first_stop, n_steps))
    att = att_buf[:max_seqlen].permute(1, 0, 2, 3) if return_att else None
    return GenerateResult(tokens[:max_seqlen].permute(2, 1, 0), stop_mask, lengths, att, n_steps)


def cut_outputs(result: GenerateResult, n_quant: int, n_special_token_in: int = 3):
    """Host-side per-row trimming (reference modeling_lina.py:181-192).

    Returns a list of (codes (q, 1, len_i) numpy, att_i or None) with the
    delay pattern inverted and the special-token offset removed.
    """
    qs = result.tokens.cpu()
    rvq = np.clip(undelay_rvq(qs).numpy() - n_special_token_in, 0, None)
    att = result.att.float().cpu().numpy() if result.att is not None else None
    stop = result.stop_mask.cpu().numpy()
    outs = []
    for i, L in enumerate(result.lengths.cpu().numpy()):
        idx = int(L) - 1 if stop[i].any() else int(L)
        end = max(idx - n_quant, 0)
        outs.append((rvq[:, [i], :end], att[i, :idx] if att is not None else None))
    return outs
