"""Initial-state tuning: speaker adaptation by optimizing the recurrent S0.

Counterpart of ``lina_speech_tpu/train/initial_state.py`` (reference
initial_state.py:85-160). Instead of a prompt, the speaker identity is
distilled into per-layer LoRA-factorized initial states
(k: (1, r, h, d_k, 1), v: (1, r, h, 1, d_v)); only these are trained (Adam,
lr 0.1, gradient accumulation), with the loss backpropagating through the
GLA prefill into S0: on a CUDA device that gradient is the ``ds0`` of the
hand-written ``gla_chunk_conv`` backward, or of ``gla_chunk``'s for layers
without per-projection convs (``ops/gla_cuda.py``). It covers the
``AttentiveGLA`` backbones (kinds ``gla`` and ``simple_gla``), as in the JAX
package.

Under data and context parallelism (a model built with ``mesh=``, batches
cut by ``parallel/sharding.py:shard_batch``) the S0 params are replicated:
every rank draws them from the same seed, and their gradients are summed
over the dp x cp group, as shard_map's transpose sums them in JAX (under
cp each rank's share reaches S0 through ``ops/gla_cp.py``'s exchange).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from lina_speech_tpu_torch.models.lina import LinaModel
from lina_speech_tpu_torch.parallel.collectives import all_reduce_grads_, all_reduce_sum
from lina_speech_tpu_torch.utils.convert import tuning_params_to_arrays


@dataclasses.dataclass(frozen=True)
class InitialStateTuningConfig:
    lr: float = 0.1
    rank: int = 1
    scale: float = 0.02
    grad_acc: int = 4
    batch_size: int = 2
    n_samples: int = 256
    seed: int = 123


def tuning_leaves(tune_params: List) -> List[torch.Tensor]:
    """The tensors of the S0 params, block by block (k then v)."""
    return [t for p in tune_params for t in (p if isinstance(p, tuple) else (p,))]


@contextlib.contextmanager
def _frozen(model: torch.nn.Module):
    """The model's parameters take no gradient inside: autograd then skips
    every weight gradient on the way to S0."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def make_tuning_step(model: LinaModel, config: InitialStateTuningConfig,
                     tune_params: List, optimizer: torch.optim.Optimizer) -> Callable:
    """One micro-step ``(micro_idx, batch) -> loss``: loss and gradients
    w.r.t. the S0 params only (accumulated in their ``.grad``), and an
    optimizer update every ``grad_acc`` micro-steps on their mean (reference
    initial_state.py:139-150 steps the optimizer on that cadence). The model
    runs in eval mode and its parameters are left untouched."""
    leaves = tuning_leaves(tune_params)

    def step(micro_idx: int, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with _frozen(model):
            init_state = model.attentive_rnn.state_from_params(
                tune_params, batch["text_token"].shape[0], scale=config.scale)
            _, loss, _ = model(
                batch["text_token"],
                batch["audio_token"],
                batch.get("encoder_mask"),
                batch.get("crossatt_mask"),
                logits_mask=batch.get("y_mask"),
                init_state=init_state,
            )
            grads = torch.autograd.grad(loss, leaves)
        all_reduce_grads_(grads, model.data_group)
        for p, g in zip(leaves, grads):
            p.grad = g if p.grad is None else p.grad + g
        if micro_idx % config.grad_acc == config.grad_acc - 1:
            for p in leaves:
                p.grad /= config.grad_acc
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return all_reduce_sum(loss, model.data_group)

    return step


def train_initial_state(
    model: LinaModel,
    batches: Iterable[Dict[str, torch.Tensor]],
    config: InitialStateTuningConfig = InitialStateTuningConfig(),
    generator: Optional[torch.Generator] = None,
    save_every_k_steps: int = 0,
) -> Tuple[List, List[float]]:
    """Run the tuning loop over an iterable of collated batches (tensors on
    the model's device).

    Returns (tuned S0 params [or list of snapshots], losses). Mirrors
    reference train_initial_state's outputs (initial_state.py:156-160).
    ``generator`` (on the model's device; seeded with ``config.seed`` if not
    given) draws the initial S0 params.
    """
    if not hasattr(model.attentive_rnn, "init_state_tuning_params"):
        raise TypeError("initial-state tuning needs an AttentiveGLA backbone, not "
                        f"{type(model.attentive_rnn).__name__}")
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(config.seed)
    tune_params = model.attentive_rnn.init_state_tuning_params(
        generator, rank=config.rank, scale=config.scale)
    for t in tuning_leaves(tune_params):
        t.requires_grad_(True)
    optimizer = torch.optim.Adam(tuning_leaves(tune_params), lr=config.lr)
    step = make_tuning_step(model, config, tune_params, optimizer)

    losses: List[float] = []
    snapshots: List = []
    k_steps = 0
    for i, batch in enumerate(batches):
        losses.append(float(step(i, batch)))
        if (i + 1) % config.grad_acc == 0:
            k_steps += 1
            if save_every_k_steps > 0 and k_steps % save_every_k_steps == 0:
                snapshots.append(tuning_params_to_arrays(tune_params))

    if save_every_k_steps > 0:
        snapshots.append(tuning_params_to_arrays(tune_params))
        return snapshots, losses
    return tune_params, losses


def speaker_state_dict(tune_params: List) -> Dict[str, np.ndarray]:
    """Flatten S0 params for saving (reference initial_state.py:20-30)."""
    out = {}
    for i, layer in enumerate(tune_params):
        if isinstance(layer, tuple):
            out[f"layer{i}_k"], out[f"layer{i}_v"] = layer
        else:
            out[f"layer{i}"] = layer
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


def parse_speaker_state(state: Dict[str, Any], device=None) -> List:
    """Inverse of :func:`speaker_state_dict` (initial_state.py:39-48)."""
    num = lambda s: int("".join(c for c in s if c.isdigit()))
    tensor = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    ks = sorted((k for k in state if k.endswith("_k")), key=num)
    if ks:
        return [(tensor(state[k]), tensor(state[k[:-2] + "_v"])) for k in ks]
    return [tensor(state[k]) for k in sorted(state, key=num)]
