"""Training harness: optimizer, schedule, train and eval steps.

Counterpart of ``lina_speech_tpu/train/harness.py`` (which replaces the
reference's Lightning harness, train_lina.py): AdamW (lr 5e-4, wd 0.1,
betas (0.9, 0.999)) with an HF-style cosine schedule with warmup stepped
per optimizer step (train_lina.py:105-120), masked CE loss, top-10 accuracy
per quantizer ignoring pad/head tokens (train_lina.py:57-61).

The step is a plain eager PyTorch step on one device; with data and context
parallelism (a model built with ``mesh=``) each rank runs it on its part of
the batch and the gradients are summed over the dp x cp group after the
local backward, in one all_reduce (``parallel/collectives.py``): the
model's loss is each rank's share of the global masked mean
(``models/lina.py``), so the sum is the single-process gradient of the
whole batch, and every parameter (``s0``, ``u``, ``A`` and ``D`` too) is
replicated over both axes. Clipping then sees the same global norm on
every rank; the loss and accuracies reported are the global ones. The model carries its
parameters (f32); its modules cast them to the compute dtype at each matmul,
so gradients arrive in f32. On a CUDA device every GLA-family layer trains
through hand-written forward and backward kernels (``ops/gla_cuda.py``):
``gla_chunk_conv`` with per-projection short convs, ``gla_chunk`` without
them (simple-GLA, the interleaved and PP backbones without convs) and in
Mamba-2; an RWKV6 layer through ``rwkv6_chunk`` and its hand-written
backward (``ops/rwkv6_cuda.py``); a Mamba (v1) mixer through
``mamba_scan`` and its hand-written backward (``ops/mamba_cuda.py``). The
JAX step's ``auto_layout``, ``hoist_param_cast``, ``unroll_accum`` and
``donate`` are XLA machinery with no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lina_speech_tpu_torch.models.accuracy import topk_accuracy, topk_hits
from lina_speech_tpu_torch.models.lina import LinaModel
from lina_speech_tpu_torch.parallel.collectives import all_reduce_grads_, all_reduce_sum


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-4
    weight_decay: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.999)
    n_warmup_steps: int = 500
    n_training_steps: int = 300_000
    grad_clip: Optional[float] = None
    accuracy_top_k: int = 10
    # micro-batching: batch axis is split into this many sequential chunks
    # (activation memory / grad_accum_steps; Lightning's
    # accumulate_grad_batches equivalent)
    grad_accum_steps: int = 1


def cosine_schedule_with_warmup(peak_lr: float, warmup_steps: int,
                                total_steps: int) -> Callable[[int], float]:
    """HF get_cosine_schedule_with_warmup semantics (train_lina.py:117-118):
    the learning rate of the optimizer step that follows ``step`` earlier
    ones, so the first step of a warmup runs at 0."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * min(max(progress, 0.0), 1.0)))

    return schedule


@dataclasses.dataclass
class TrainState:
    """The model (which holds the parameters), its optimizer and the number
    of optimizer steps taken."""

    model: LinaModel
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    config: TrainConfig
    step: int = 0


def create_train_state(model: LinaModel, config: TrainConfig) -> TrainState:
    """One AdamW group over every parameter: optax's ``adamw`` decays every
    leaf, norm scales and biases too, and so does this."""
    sched = cosine_schedule_with_warmup(
        config.learning_rate, config.n_warmup_steps, config.n_training_steps)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=sched(0), betas=config.betas, eps=1e-8,
        weight_decay=config.weight_decay)
    return TrainState(model=model, optimizer=optimizer, schedule=sched, config=config)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch (``data/collate.py``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def _loss_and_metrics(model: LinaModel, batch: Dict[str, torch.Tensor]):
    logits, loss, _ = model(
        batch["text_token"],
        batch["audio_token"],
        batch.get("encoder_mask"),
        batch.get("crossatt_mask"),
        logits_mask=batch.get("y_mask"),
        reset_mask=batch.get("reset_mask"),
        crossatt_pos=batch.get("crossatt_pos"),
    )
    target = batch["audio_token"][:, 1:]
    y_mask = batch.get("y_mask")
    mask = y_mask[:, 1:] if y_mask is not None else None
    group = model.data_group
    with torch.no_grad():
        if group is None:
            metrics = {"loss": loss.detach()}
            for i in range(logits.shape[2]):
                metrics[f"acc_{i}"] = topk_accuracy(logits[:, :, i], target[:, :, i], mask=mask)
            return loss, metrics
        # the global loss and accuracies: the loss's shares, each quantizer's
        # hits and counts summed over the group in one all_reduce
        parts = [loss.detach().float()]
        for i in range(logits.shape[2]):
            parts += [x.float() for x in topk_hits(logits[:, :, i], target[:, :, i], mask=mask)]
        total = all_reduce_sum(torch.stack(parts), group)
        metrics = {"loss": total[0]}
        for i in range(logits.shape[2]):
            metrics[f"acc_{i}"] = total[1 + 2 * i] / total[2 + 2 * i].clamp(min=1)
    return loss, metrics


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all ``tensors``, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_train_step(model: LinaModel, grad_accum_steps: int = 1) -> Callable:
    """Build the train step ``(state, batch, generator=None) -> (state,
    metrics)``. ``batch`` holds tensors on the model's device
    (:func:`batch_to_device`); ``generator`` (on that device) feeds dropout
    and the text masking and is needed only where either is on.

    With ``grad_accum_steps > 1`` the batch's leading axis is split into
    micro-batches run one after another (activation memory divides by the
    accumulation factor); gradients accumulate in f32 and are averaged.
    Metrics are 0-dim tensors: the loss and accuracies averaged over the
    micro-batches and ``grad_norm``, the global norm before any clipping.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model.train()
        model.set_generator(generator)
        state.optimizer.zero_grad(set_to_none=True)
        totals: Dict[str, torch.Tensor] = {}
        for i in range(grad_accum_steps):
            micro = batch if grad_accum_steps == 1 else {
                k: v.reshape(grad_accum_steps, v.shape[0] // grad_accum_steps, *v.shape[1:])[i]
                for k, v in batch.items()}
            loss, metrics = _loss_and_metrics(model, micro)
            loss.backward()
            for k, v in metrics.items():
                totals[k] = totals[k] + v if k in totals else v
        if model.data_group is not None:
            # every rank reduces the same tensors: a parameter this rank's
            # part of the batch did not reach gets a zero gradient
            for p in model.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        all_reduce_grads_(grads, model.data_group)
        if grad_accum_steps > 1:
            torch._foreach_div_(grads, grad_accum_steps)
        metrics = {k: v / grad_accum_steps for k, v in totals.items()}
        metrics["grad_norm"] = global_norm(grads)
        clip = state.config.grad_clip
        if clip is not None:
            # optax.clip_by_global_norm: untouched below the limit
            torch._foreach_mul_(grads, clip / torch.clamp(metrics["grad_norm"], min=clip))
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: LinaModel) -> Callable:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.eval()
        return _loss_and_metrics(model, batch)[1]

    return eval_step
