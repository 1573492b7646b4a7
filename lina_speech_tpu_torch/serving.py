"""Slot-based continuous-batching decode server (PyTorch port).

Counterpart of ``lina_speech_tpu/serving.py``: a fixed pool of ``n_slots``
decode slots runs one chunked decode loop; a finished stream frees its
slot, which is refilled from the request queue by a single-request prefill
inserted into the batched state, so short utterances never hold the batch
hostage.

Everything device-side has a fixed shape: text is padded to
``max_text_len`` with a cross-attention mask (and, for the convolutional
positions, ``crossatt_pos_valid``), each slot has its own ``time_step``,
and a request's rows are written into the batch axis of every state leaf
(conv rings are (w, b, dim), recurrent states (b, h, ...)) at chunk
boundaries only.

A voice-clone prompt of any length prefills at b=1 as its BINARY
DECOMPOSITION into descending power-of-two chunks (13 -> 8 + 4 + 1), each
chunk threading the backbone state (recurrent states, conv rings through
``conv_history``, rotary positions through ``time_offset``) -- the same
recurrence, so the set of prefill shapes stays bounded by log2(longest
prompt) + 1. The first chunk runs the conv-fused prefill kernel
(``gla_chunk_conv``), the following ones the convs on the carried rings
and ``gla_chunk``.

``lazy=True`` decodes each chunk as one lazy window
(``generate_batch(lazy_window=chunk)``'s machinery): the recurrent states
are only read across the chunk's steps (``gla_decode_lazy_conv``) and one
fold per chunk lands the buffered rank-L update (``gla_fold``). Insertion
happens after the fold, which is the condition of generate's post-prefill
``add_lazy_buffers``, so greedy lazy serving equals the request's own
``generate_batch(lazy_window=chunk)`` run. The classic mode steps
``gla_decode_conv`` token by token.

``weight_quant="int8"`` runs the decode chunks on int8 copies of the large
Linear weights and the logits head (``generate_batch``'s contract: prefill
and text encoding at full precision, so int8 serving equals
``generate_batch(weight_quant="int8")``); ``int8_prefill_full_precision=
False`` keeps only the int8 copies resident and then prefills through them
too. ``state_quant="int8"`` (lazy mode only) keeps the slots' base states
int8 with one scale per row, ``"int4"`` int4 two values a byte (the slot
container's ``s`` then (slots, h, dk, dv // 2)).

``cfg_coef`` serves with classifier-free guidance (``generate_batch``'s
math): the device batch doubles to ``2 * n_slots`` rows, a request's
conditional row in its slot and its all-mask row ``n_slots`` further, both
prefilled together (g = 2), and every step samples from ``l_uncond +
cfg_coef * (l_cond - l_uncond)``. As in the JAX server, the speaker encoder
is not run on a request's prompt (``generate_batch`` runs it), and a
backbone whose state keeps a clock the batch shares (the transformer's KV
cache) is refused with ``ValueError``: slots at different progress cannot
share its decode batch.

The JAX server's jitted programs are plain host loops here, under
``torch.no_grad()``, with one host read of the sampled tokens per chunk.
``mesh`` is not ported and raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from lina_speech_tpu_torch.generate import _batch_axis, _guide, _sample_tokens, _tile
from lina_speech_tpu_torch.models.attentive_rnn import (
    BackboneState, add_lazy_buffers, map_state,
)
from lina_speech_tpu_torch.models.base_blocks import use_int8_weights
from lina_speech_tpu_torch.models.crossatt import ConvPos
from lina_speech_tpu_torch.models.gla_layer import check_state_quant
from lina_speech_tpu_torch.models.lina import LinaModel

STOP_ID = 2


@dataclasses.dataclass
class _Slot:
    rid: Optional[int] = None
    t: int = 0            # next free-running step (== n_pre after prefill)
    max_len: int = 0
    tokens: Optional[List[np.ndarray]] = None  # produced (q,) rows


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray    # (length, q) raw codec tokens (delay pattern)
    length: int
    stopped: bool         # True: emitted the stop token; False: hit max_len


def _pow2_chunks(n: int) -> List[int]:
    """Binary decomposition of ``n`` into descending powers of two."""
    out, bit = [], 1 << (n.bit_length() - 1)
    while n:
        if n >= bit:
            out.append(bit)
            n -= bit
        bit >>= 1
    return out


class DecodeServer:
    """Continuous-batching TTS decode engine.

    Usage::

        srv = DecodeServer(model, n_slots=8, max_text_len=64)
        srv.submit(text_ids, max_len=400)         # -> request id
        done = srv.run()                          # drain queue + slots

    The server runs where the model's parameters are. It keeps copies of
    the model's f32 parameters cast to the compute dtype (the JAX server's
    pre-cast tree) and swaps them in for its own calls only: the caller's
    model is left as it was (but see ``int8_prefill_full_precision``). A
    Mamba, Mamba-2 or RWKV6 backbone serves in classic mode; ``lazy=True``
    (and so ``state_quant``) raises ``TypeError`` for it, as in JAX.

    ``weight_quant="int8"`` (with ``quant_min_size`` and ``quant_exclude`` as
    in ``generate_batch``) makes int8 copies of the weights at construction
    and runs every decode chunk on them. With
    ``int8_prefill_full_precision=True`` (the default) prefill and text
    encoding use the float weights; ``False`` drops the float weights of the
    quantized layers FROM THE MODEL, so only the int8 copies stay resident
    and every later forward of that model goes through them, at m = chunk
    length in a prefill. ``state_quant="int8"`` or ``"int4"`` needs
    ``lazy=True``: the slot container then holds an int8 ``s`` (with int4,
    of last dim dv / 2, two values a byte) and an f32 ``s_scale`` per layer,
    sized from what ``add_lazy_buffers`` makes of an empty state and filled
    as a prefill followed by ``add_lazy_buffers`` produced them.

    ``cfg_coef`` (a model trained with ``mask_text_p > 0``, else
    ``ValueError``) guides every request: ``2 * n_slots`` device rows, the
    speaker encoder not run (see the module docstring). The transformer
    backbone raises ``ValueError`` (its KV clock is shared by the batch).

    Raising ``NotImplementedError``: ``mesh`` (ROADMAP.md Queue 1 item 11b),
    ``approx_topk`` (a TPU op). Not ported on purpose: the JAX server's
    ``sf_emit_dtype`` policy (f32 emission of the prefill kernels' final
    state, a TPU scheduling matter: the value quantized is the same) and
    the ``QLINEAR_*`` environment variables (w8a8 is the ``quant_mode``
    attribute of a quantized ``Linear``).
    """

    def __init__(
        self,
        model: LinaModel,
        n_slots: int = 8,
        max_text_len: int = 64,
        chunk: int = 16,
        k: int = 1,
        temp: float = 1.0,
        first_greedy_quant: int = 1,
        seed: int = 0,
        weight_quant: Optional[str] = None,
        quant_min_size: int = 1 << 16,
        quant_exclude=None,
        approx_topk: bool = False,
        int8_prefill_full_precision: bool = True,
        mesh=None,
        cfg_coef: Optional[float] = None,
        lazy: bool = False,
        state_quant: Optional[str] = None,
    ):
        for name, val, ready in (
                ("mesh", mesh, "ROADMAP.md Queue 1 item 11b"),
                ("approx_topk", approx_topk, "a TPU op; the port samples exact top-k")):
            if val:
                raise NotImplementedError(f"DecodeServer({name}=...) is not "
                                          f"ported ({ready})")
        check_state_quant(state_quant)
        if state_quant is not None and not lazy:
            raise ValueError("state_quant requires lazy=True (it rides the "
                             "lazy base-state layout)")
        if weight_quant not in (None, "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}")
        if cfg_coef is not None and model.mask_text_p <= 0.0:
            raise ValueError("cfg_coef requires a model trained with "
                             "mask_text_p > 0 (no mask token otherwise)")
        for st in model.empty_state(1, device="meta").layers:
            if any(getattr(st, f.name) is not None and not torch.is_tensor(getattr(st, f.name))
                   for f in dataclasses.fields(st)):
                # the transformer's KV clock: one per layer, shared by the
                # batch, so slots at different progress cannot share it
                raise ValueError(
                    "DecodeServer requires per-slot state; this backbone keeps a "
                    "batch-shared scalar in its state (transformer KV-cache clock) "
                    "and cannot mix slot progress")
        self.model = model
        self.n_slots = n_slots
        self.max_text_len = max_text_len
        self.chunk = chunk
        self._lazy = lazy
        self._state_quant = state_quant
        self._int8 = weight_quant == "int8"
        self._cfg = cfg_coef
        self.sample_args = (k, temp, first_greedy_quant)
        self.device = next(model.parameters()).device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        self._queue: deque = deque()
        self._slots = [_Slot() for _ in range(n_slots)]
        self._done: List[Completion] = []
        # distinct prefill chunk lengths run so far (the bounded-shape
        # contract; tests assert on it)
        self.prefill_chunk_sizes: set = set()

        self._params = model.cast_param_copies()
        with model.using_params(self._params):
            if self._int8:
                model.quantize_weights_(min_size=quant_min_size, exclude=quant_exclude)
                if not int8_prefill_full_precision:
                    model.drop_float_weights_()
        # the copies of weights the model gave up are not kept either
        held = {id(p) for p in model.parameters()}
        self._params = {p: c for p, c in self._params.items() if id(p) in held}
        cdt, dev = model.dtype, self.device
        # under CFG rows [0, n_slots) are conditional, [n_slots, 2 n_slots)
        # the same slots against the all-mask text
        d, m, B = model.d_model, max_text_len, n_slots * (2 if cfg_coef is not None else 1)
        self._x_enc = torch.zeros(B, m, d, dtype=cdt, device=dev)
        self._ca_mask = torch.zeros(B, 1, m, dtype=torch.bool, device=dev)
        self._y_embd = torch.zeros(B, d, dtype=cdt, device=dev)
        self._t = torch.zeros(B, dtype=torch.long, device=dev)

        # batch axis of every state leaf, from the shapes of a one-row and
        # a B-row empty state
        shape_of = lambda n: map_state(lambda z: z.shape,
                                       self._with_buffers(model.empty_state(n, device="meta")))
        self._batch_shapes = shape_of(B)
        self._axes = map_state(lambda bs, os: _batch_axis(bs, os, B),
                               self._batch_shapes, shape_of(1))
        # The slot container is allocated at the first insertion, with the
        # dtypes of what a prefill produced -- not empty_state's defaults:
        # insertion casts a request's rows to the container's dtypes, so a
        # container in other dtypes would serve a bf16 model from f32
        # states and rings.
        self._state: Optional[BackboneState] = None

        # ConvPos (non-causal 31-tap positional conv) must be told the
        # valid text length so the padded batch matches each request's
        # unpadded generate_batch run exactly
        rnn = model.attentive_rnn
        self._pos_needs_valid = rnn.blind and isinstance(rnn.cross_att.pos_embed, ConvPos)

    # ------------------------------------------------------------ device side
    def _with_buffers(self, state: BackboneState) -> BackboneState:
        if not self._lazy:
            return state
        return add_lazy_buffers(state, self.chunk, dtype=self.model.dtype,
                                state_quant=self._state_quant)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        k, temp, fgq = self.sample_args
        return _sample_tokens(self._gen, logits, k, temp, fgq)

    def _prefill_chunk(self, x_enc, ca_mask, codes_chunk, time_offset: int,
                       conv_history: bool, state: BackboneState):
        """One power-of-two prefill chunk for one request: g = 1 row, or 2
        under CFG (the conditional and the all-mask row on the same codes).
        ``codes_chunk``: (q, g, c); ``state`` threads between chunks
        (``conv_history`` consumes its conv rings mid-stream). Returns
        (tokens (c, q), new_state of g rows)."""
        emb = self.model.embed_tokens(codes_chunk)  # (g, c, d)
        g, c = emb.shape[:2]
        pf_mask = ca_mask.expand(g, c, ca_mask.shape[-1])
        pv = ca_mask[:, 0] if self._pos_needs_valid else None  # (g, m)
        logits, _, state = self.model.prefill(
            emb, x_enc, state, crossatt_mask=pf_mask, conv_history=conv_history,
            time_offset=time_offset, crossatt_pos_valid=pv)  # (g, c, q, l)
        return self._sample(_guide(logits, self._cfg))[0], state

    def _insert(self, one_state: BackboneState, x_enc1, ca1, y1, t1: int,
                slot_idx: int) -> None:
        """Write a request's g rows into every batched tensor, in place, cast
        to the container's dtypes: row 0 at ``slot_idx``, under CFG row 1
        (the all-mask row) at ``n_slots + slot_idx``. In lazy mode the fresh
        rows get zeroed window buffers; insertion happens at chunk
        boundaries (after the fold), the condition of generate_batch's
        post-prefill ``add_lazy_buffers``."""
        one_state = self._with_buffers(one_state)
        if self._state is None:
            self._state = map_state(
                lambda shape, leaf: torch.zeros(shape, dtype=leaf.dtype,
                                                device=leaf.device),
                self._batch_shapes, one_state)
        targets = [slot_idx] if self._cfg is None else [slot_idx, self.n_slots + slot_idx]
        for j, row in enumerate(targets):
            map_state(lambda bl, ol, ax: bl.select(ax, row).copy_(ol.select(ax, j)),
                      self._state, one_state, self._axes)
            self._x_enc[row] = x_enc1[j]
            self._ca_mask[row] = ca1[j]
            self._y_embd[row] = y1[j]
            self._t[row] = t1

    def _decode_chunk(self) -> np.ndarray:
        """``chunk`` decode steps of every slot (lazy: one window and its
        fold). Returns the sampled tokens (chunk, n_slots, q) on the host
        (under CFG sampled from the guided logits of the 2 n_slots rows)."""
        model = self.model
        pv = self._ca_mask[:, 0] if self._pos_needs_valid else None  # (B, m)
        state, y_embd, t = self._state, self._y_embd, self._t
        rows = []
        with use_int8_weights(model, on=self._int8):
            for j in range(self.chunk):
                logits, _, state = model.decode_step(
                    y_embd, self._x_enc, state, time_step=t,
                    lazy_p=j if self._lazy else None,
                    crossatt_mask=self._ca_mask, crossatt_pos_valid=pv)
                toks = self._sample(_guide(logits, self._cfg))  # (n_slots, q)
                y_embd = _tile(model.embed_tokens(toks.T[:, :, None])[:, 0], self._cfg)
                t = t + 1
                rows.append(toks)
        if self._lazy:
            # one unconditional fold per chunk: the buffered window lands
            # in the base states; the buffers stay stale (masked by the
            # next chunk's lazy_p, rewritten before its fold reads them)
            state = model.fold_lazy_state(state)
        self._state, self._y_embd, self._t = state, y_embd, t
        return torch.stack(rows).cpu().numpy()

    # ------------------------------------------------------------ host API
    def submit(self, text_ids, prompt=None, max_len: int = 400) -> int:
        """Queue a request. ``text_ids``: (m,) BPE ids (m <= max_text_len);
        ``prompt``: optional (q, p) raw codec codes for voice cloning."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.asarray(text_ids), prompt, max_len))
        return rid

    def _refill(self) -> None:
        # keep filling until no free slot or the queue drains -- a request
        # that completes AT prefill (stop in the prompt predictions, or
        # max_len <= n_forced) frees its slot immediately and the next
        # queued request must take it in the same pass
        while self._queue:
            slot_idx = next((i for i, s in enumerate(self._slots)
                             if s.rid is None), None)
            if slot_idx is None:
                return
            rid, text, prompt, max_len = self._queue.popleft()
            self._fill_slot(slot_idx, rid, text, prompt, max_len)

    def _fill_slot(self, slot_idx, rid, text, prompt, max_len) -> None:
        model, dev, m = self.model, self.device, self.max_text_len
        mlen = len(text)
        if mlen > m:
            raise ValueError(f"text length {mlen} > max_text_len {m}")
        g = 1 if self._cfg is None else 2
        x = torch.zeros(g, m, dtype=torch.long, device=dev)
        x[0, :mlen] = torch.as_tensor(text, dtype=torch.long, device=dev)
        if g == 2:
            # the unconditional row: the mask token at every valid position
            x[1, :mlen] = model.n_txt_vocab - 1
        valid = torch.arange(m, device=dev) < mlen
        # the encoder ORs the identity in, so padded rows attend to themselves
        enc_mask = (valid[:, None] & valid[None, :])[None].expand(g, m, m)
        ca1 = valid[None, None, :].expand(g, 1, m)
        nq = model.n_quant
        codes = np.ones((nq, 1, 1), np.int64)
        if prompt is not None:
            p = np.asarray(prompt)
            codes = np.concatenate(
                [codes, p[:, None, :].astype(np.int64) + model.n_special_token_in],
                axis=2)
        n_forced = codes.shape[2]
        codes = torch.from_numpy(codes).to(dev).expand(nq, g, n_forced)

        x_enc1 = model.encode_text(x, enc_mask)
        # binary-decomposed prefill: descending pow2 chunks, state threaded
        st1 = model.empty_state(g, device=dev)
        pre_toks = []
        off = 0
        for c in _pow2_chunks(n_forced):
            self.prefill_chunk_sizes.add(c)
            toks, st1 = self._prefill_chunk(
                x_enc1, ca1, codes[:, :, off:off + c], off,
                conv_history=(off > 0), state=st1)
            pre_toks.append(toks)
            off += c
        pre_toks = torch.cat(pre_toks)  # (n_forced, q)
        y1 = _tile(model.embed_tokens(pre_toks[-1][:, None, None])[:, 0], self._cfg)  # (g, d)
        self._insert(st1, x_enc1, ca1, y1, n_forced, slot_idx)
        self._slots[slot_idx] = _Slot(rid=rid, t=n_forced, max_len=max_len,
                                      tokens=list(pre_toks.cpu().numpy()))
        self._maybe_finish(slot_idx)

    def _maybe_finish(self, slot_idx: int) -> None:
        slot = self._slots[slot_idx]
        if slot.rid is None:
            return
        stop_at = next((i for i, row in enumerate(slot.tokens)
                        if (row == STOP_ID).all()), None)
        if stop_at is not None or len(slot.tokens) >= slot.max_len:
            length = (stop_at + 1) if stop_at is not None else slot.max_len
            self._done.append(Completion(
                rid=slot.rid, tokens=np.stack(slot.tokens[:length]),
                length=length, stopped=stop_at is not None))
            self._slots[slot_idx] = _Slot()

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if s.rid is not None)

    def partials(self) -> Dict[int, np.ndarray]:
        """Tokens produced so far per ACTIVE request: {rid: (steps, q)}.
        Streaming consumers poll this between ``run(max_chunks=1)`` calls."""
        return {s.rid: np.stack(s.tokens) for s in self._slots
                if s.rid is not None and s.tokens}

    @torch.no_grad()
    def run(self, max_chunks: Optional[int] = None) -> List[Completion]:
        """Drain queue + slots; returns completions in finish order."""
        chunks = 0
        with self.model.using_params(self._params):
            self._refill()
            while self.active and (max_chunks is None or chunks < max_chunks):
                toks = self._decode_chunk()  # (chunk, B, q)
                for slot_idx, slot in enumerate(self._slots):
                    if slot.rid is None:
                        continue
                    room = max(slot.max_len - len(slot.tokens), 0)
                    slot.tokens.extend(toks[:room, slot_idx])
                    self._maybe_finish(slot_idx)
                self._refill()
                chunks += 1
        out, self._done = self._done, []
        return out
