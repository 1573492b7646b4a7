"""Training CLI of the port:
``python -m lina_speech_tpu_torch.train.cli fit --config configs/lina_gla_169m.yaml``.

Counterpart of ``lina_speech_tpu/train/cli.py`` (which replaces the
reference's LightningCLI entry, train_lina.py:122-132): an argparse and
YAML front end over :func:`train.harness.make_train_step` on one device a
process, the card unless ``--device cpu`` is given. It reads synthetic batches or
npz shards (:func:`build_data`), warm-starts from a checkpoint's weights
(``--load-weights``), saves the full train state every ``--ckpt-every``
steps and at the end (``utils/checkpoint.py``), resumes from the latest
``step_<n>`` (``--resume``), runs eval passes and logs JSONL metrics.

The step order is the JAX CLI's: the first batch is drawn before training
and feeds step 0; a resumed run restores the parameters, both Adam moments
and the step, and restarts the data iterator (no fast-forward). A
checkpoint is named after the optimizer steps its state has taken, and a
resumed run starts there. Dropout and the text masking of step ``n`` draw
from a generator seeded from (``seed + 1``, ``n``), the port's
``fold_in(rng, state.step)``, so a resumed step draws what the unbroken
run drew.

Data and context parallel training (``--dp``, ``--cp``): one process a
rank, started by torchrun (``torchrun --nproc-per-node N -m
lina_speech_tpu_torch.train.cli fit --dp D --cp C``, D x C = N) or by hand
with ``--coordinator host:port`` and each process's ``RANK`` (and
``WORLD_SIZE``, else D x C) in its environment; NCCL on the cards (rank r
on ``cuda:LOCAL_RANK``), gloo with ``--device cpu``. Every rank builds
the same global batch from the seed (JAX rounds the batch size up to a
multiple of dp, and so does this) and trains on its part
(``parallel/sharding.py:shard_batch``); rank 0's parameters are broadcast
once; only rank 0 logs and writes checkpoints, whose keys are the model's
own (no wrapper), so a checkpoint of one layout resumes in any other. A
step's generator is seeded from (``seed + 1``, ``n``) and this rank's dp
index, so the cp ranks of a row draw alike. ``--cp`` above 1 on the
transformer raises ``ValueError``, as the JAX CLI refuses it; ``--tp``
above 1 raises ``NotImplementedError`` (ROADMAP.md Queue 1 item 11b).
JAX's ``--platform`` has no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch


def build_data(data_cfg: Dict[str, Any], model_cfg, dp: int = 1
               ) -> Iterator[Dict[str, np.ndarray]]:
    """The endless iterator of collated numpy batches a config's ``data``
    section asks for: ``kind: synthetic`` (the default) or ``kind: npz``
    (``npz_paths``, ``max_tokens``, ``tokenizer_file``). The batch size is
    rounded up to a multiple of ``dp``, as in JAX."""
    kind = data_cfg.get("kind", "synthetic")
    batch_size = -(-int(data_cfg.get("batch_size", 8)) // dp) * dp
    if kind == "synthetic":
        from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches

        return synthetic_tts_batches(
            batch_size=batch_size,
            n_quant=model_cfg.n_quant,
            n_codebook=model_cfg.n_codebook,
            min_audio_len=int(data_cfg.get("min_audio_len", 64)),
            max_audio_len=int(data_cfg.get("max_audio_len", 256)),
            seed=int(data_cfg.get("seed", 0)),
            structured=bool(data_cfg.get("structured", False)),
        )
    if kind == "npz":
        from lina_speech_tpu_torch.data.dataset import (
            LengthBucketSampler, TokenizedTTSDataset, tts_data_loader,
        )
        from lina_speech_tpu_torch.data.tokenizer import TextTokenizer

        ds = TokenizedTTSDataset(npz_paths=data_cfg["npz_paths"])
        sampler = LengthBucketSampler(
            ds.lengths(),
            max_tokens=int(data_cfg.get("max_tokens", 8192)),
            max_batch_size=batch_size,
            seed=int(data_cfg.get("seed", 0)),
        )
        tok = TextTokenizer(data_cfg.get("tokenizer_file"))
        return tts_data_loader(ds, tok, sampler, n_special=model_cfg.n_special_token_in)
    raise ValueError(f"unknown data kind {kind!r}")


def step_generator(seed: int, step: int, device, dp_index: int = 0) -> torch.Generator:
    """The generator of optimizer step ``step``: seeded from (``seed + 1``,
    ``step``) and, above dp index 0, the index, on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (((seed + 1) << 32) + step + (dp_index << 56)) & 0xFFFF_FFFF_FFFF_FFFF)


def start_world(args):
    """The mesh of ``--dp`` x ``--tp`` x ``--cp`` over the world this
    process joins (``parallel/multihost.py:distributed_init``: torchrun's
    environment or ``--coordinator``), host-major as JAX lays a multi-host
    mesh out, and this process's device."""
    from lina_speech_tpu_torch.parallel import MeshConfig, distributed_init, make_multihost_mesh
    from lina_speech_tpu_torch.parallel.multihost import local_device

    if args.tp > 1:
        raise NotImplementedError(f"--tp {args.tp}: tensor parallelism is not ported yet "
                                  "(ROADMAP.md Queue 1 item 11b)")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("fit: no CUDA device; pass --device cpu to train on the CPU")
    device = local_device(args.device or "cuda")
    world = args.dp * args.tp * args.cp
    distributed_init(args.coordinator, device=device, num_processes=(
        world if args.coordinator and "WORLD_SIZE" not in os.environ else None))
    return make_multihost_mesh(MeshConfig(dp=args.dp, tp=args.tp, cp=args.cp)), device


def fit(args):
    """Train as the arguments say; returns the final ``TrainState``."""
    from lina_speech_tpu_torch.config import ModelConfig, build_model, load_config
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_eval_step, make_train_step,
    )
    from lina_speech_tpu_torch.parallel import replicate_params, shard_batch
    from lina_speech_tpu_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )
    from lina_speech_tpu_torch.utils.profiling import MetricsLogger, NullLogger, StepTimer

    if args.config:
        cfg = load_config(args.config)
        model_cfg, train_cfg, data_cfg = cfg["model"], cfg["train"], cfg["data"]
    else:
        model_cfg, train_cfg, data_cfg = ModelConfig(), TrainConfig(), {}
    if args.steps:
        train_cfg = dataclasses.replace(train_cfg, n_training_steps=args.steps)
    if args.cp > 1:
        if model_cfg.backbone.kind == "transformer":
            raise ValueError("--cp is not supported for the transformer baseline (no "
                             "sequence-sharded path)")
        model_cfg = dataclasses.replace(
            model_cfg, backbone=dataclasses.replace(model_cfg.backbone, cp_axis="cp"))

    mesh, device = start_world(args)
    lead = mesh.rank == 0
    model = build_model(model_cfg, device=device, seed=args.seed, mesh=mesh)
    replicate_params(model, mesh.group("dp", "cp"))
    data = build_data(data_cfg, model_cfg, dp=mesh.size("dp"))
    micro = train_cfg.grad_accum_steps
    feed = lambda b: batch_to_device(shard_batch(b, mesh, micro_batches=micro), device)
    batch0 = next(data)
    # checkpoints load to host memory and load_state_dict copies them onto
    # the model's device; the optimizer keeps each ``step`` count on the
    # host, where AdamW reads it without a device sync
    if args.load_weights:
        model.load_state_dict(restore_checkpoint(args.load_weights, map_location="cpu")["model"])
    state = create_train_state(model, train_cfg)
    resume = latest_checkpoint(args.ckpt_dir) if args.resume and args.ckpt_dir else None
    if resume is not None:
        full = restore_checkpoint(resume, map_location="cpu")
        model.load_state_dict(full["model"])
        state.optimizer.load_state_dict(full["optimizer"])
        state.step = int(full["step"])
        if lead:
            print(f"resuming from step {state.step}")
    if args.ckpt_dir and lead:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        if args.config:
            shutil.copy(args.config, os.path.join(args.ckpt_dir, "config.yaml"))

    def save():
        if lead:
            t0 = time.perf_counter()
            path = save_checkpoint(args.ckpt_dir, {"model": model.state_dict(),
                                                   "optimizer": state.optimizer.state_dict(),
                                                   "step": state.step}, step=state.step)
            print(f"saved {path} in {time.perf_counter() - t0:.1f} s")
        if torch.distributed.is_initialized():  # the others go on once it is on disk
            torch.distributed.barrier()

    train_step = make_train_step(model, grad_accum_steps=train_cfg.grad_accum_steps)
    eval_step = make_eval_step(model)
    logger = MetricsLogger(args.log_file, print_every=args.log_every) if lead else NullLogger()
    timer = StepTimer(warmup=1)  # records are per-log-interval averages
    n_params = sum(p.numel() for p in model.parameters())
    if lead:
        print(f"{n_params:,} parameters on {device}; mesh {mesh.shape}; steps {state.step} "
              f"to {train_cfg.n_training_steps}")

    t_mark, n_done, metrics = time.perf_counter(), 0, {}
    for step_idx in range(state.step, train_cfg.n_training_steps):
        batch = feed(next(data) if step_idx else batch0)
        state, metrics = train_step(state, batch, step_generator(
            args.seed, state.step, device, mesh.index("dp")))
        n_done += 1
        if step_idx % args.log_every == 0:
            # reading the metrics waits for the device: on log steps only
            metrics = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            metrics["step_time_s"] = (now - t_mark) / n_done
            timer.record(metrics["step_time_s"])
            t_mark, n_done = now, 0
            logger.log(step_idx, metrics)
        if args.ckpt_dir and step_idx > 0 and step_idx % args.ckpt_every == 0:
            save()
        if args.eval_every and step_idx > 0 and step_idx % args.eval_every == 0:
            em = eval_step(state, feed(next(data)))
            logger.log(step_idx, {f"val_{k}": float(v) for k, v in em.items()})
    if n_done:  # wait for the device and account the tail interval
        for v in metrics.values():
            float(v)
        timer.record((time.perf_counter() - t_mark) / n_done)

    if args.ckpt_dir:
        save()
    logger.close()
    if lead:
        print(f"done: {state.step} steps, mean step {timer.mean * 1e3:.1f} ms")
    return state


def main(argv=None):
    p = argparse.ArgumentParser(prog="lina_speech_tpu_torch.train.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("fit")
    f.add_argument("--config", type=str, default=None)
    f.add_argument("--steps", type=int, default=None)
    f.add_argument("--device", type=str, default=None,
                   help="default: the CUDA device (raises without one); 'cpu' to train "
                        "on the CPU")
    f.add_argument("--dp", type=int, default=1, help="data parallel ranks (batch rows)")
    f.add_argument("--tp", type=int, default=1, help="above 1: not ported (tensor parallel)")
    f.add_argument("--cp", type=int, default=1,
                   help="context parallel ranks (audio time); not for the transformer")
    f.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous, without torchrun (RANK from "
                        "the environment)")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--load-weights", type=str, default=None,
                   help="a checkpoint directory whose state has a 'model' state_dict")
    f.add_argument("--resume", action="store_true",
                   help="resume from the latest step_* in --ckpt-dir")
    f.add_argument("--ckpt-dir", type=str, default=None)
    f.add_argument("--ckpt-every", type=int, default=1000)
    f.add_argument("--eval-every", type=int, default=0)
    f.add_argument("--log-every", type=int, default=10)
    f.add_argument("--log-file", type=str, default=None)
    args = p.parse_args(argv)
    if args.cmd == "fit":
        return fit(args)


if __name__ == "__main__":
    main()
