"""Cases run under ``torch.distributed`` on the CPU (gloo), for
tests/test_torch_cp.py and tests/test_torch_parallel.py.

:class:`World` starts ``world`` processes with the ``spawn`` method, each
one thread, joins a gloo world on a free localhost port and runs the named
cases of :data:`CASES` in order; its ``results`` are every rank's (numpy),
rank by rank, and fail with the traceback of any rank that raised; a test
does its own work while the world runs. This
module imports torch, numpy and the port only: the processes do not need
JAX, the tests hold the results against it.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "lina_gla_tiny.yaml")


# ------------------------------------------------------------- the world
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, cases, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        results = {name: CASES[fn](*args) for name, (fn, args) in cases.items()}
        out.put((rank, results, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


class World:
    """``world`` processes started with the ``spawn`` method, each joining
    one gloo world and running ``cases`` (``{name: (case function name,
    args)}``) in order; :meth:`results` waits for them."""

    def __init__(self, world: int, cases: dict):
        ctx = mp.get_context("spawn")
        self.out = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_entry, args=(r, world, port, cases, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 150.0) -> list:
        """Every rank's ``{case name: result}``, rank by rank; fails with the
        traceback of a rank that raised, or after ``timeout`` seconds."""
        results, errors = [None] * len(self.procs), []
        try:
            for _ in self.procs:
                rank, res, err = self.out.get(timeout=timeout)
                if err:
                    errors.append(f"rank {rank}:\n{err}")
                    break
                results[rank] = res
        except queue.Empty:
            errors.append(f"no result within {timeout} s")
        finally:
            for p in self.procs:
                p.join(timeout=10 if not errors else 1)
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        assert not errors, "\n".join(errors)
        assert all(not p.is_alive() and p.exitcode == 0 for p in self.procs), \
            [p.exitcode for p in self.procs]
        return results


def _np(x):
    return None if x is None else x.detach().float().numpy()


# ----------------------------------------------------- context-parallel ops
def cp_op(kind: str, arrays: dict, dsf_all: np.ndarray):
    """This rank's time shard of ``arrays`` (the whole sequence, numpy)
    through ``gla_chunk_cp`` / ``rwkv6_chunk_cp`` / ``selective_scan_cp``
    over the world; the loss sum(out do) + sum(s_final dsf_r), dsf_r
    ``dsf_all[rank]``. Returns the output shard, the final state and the
    gradient of every input (the shards' for the time-sharded ones)."""
    from lina_speech_tpu_torch.ops.gla_cp import gla_chunk_cp, rwkv6_chunk_cp
    from lina_speech_tpu_torch.ops.mamba_cp import selective_scan_cp
    from lina_speech_tpu_torch.parallel.sharding import time_shard

    group, n, r = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    t_dim = 1 if kind == "mamba" else 2
    timed = {"gla": ("q", "k", "v", "gk", "do"), "rwkv6": ("r", "k", "v", "w", "do"),
             "mamba": ("x", "dt", "B", "C", "do")}[kind]
    x = {}
    for name, a in arrays.items():
        a = torch.from_numpy(a)
        if name == "reset":
            x[name] = time_shard(a.float(), n, r, 1).bool()
        elif name in timed:
            x[name] = time_shard(a, n, r, t_dim).requires_grad_(name != "do")
        else:
            x[name] = a.requires_grad_(True)
    if kind == "gla":
        leaves = ("q", "k", "v", "gk", "s0")
        o, sf = gla_chunk_cp(x["q"], x["k"], x["v"], x["gk"], x["s0"], group=group)
    elif kind == "rwkv6":
        leaves = ("r", "k", "v", "w", "u", "s0")
        o, sf = rwkv6_chunk_cp(x["r"], x["k"], x["v"], x["w"], x["u"], x["s0"], group=group)
    else:
        leaves = ("x", "dt", "A", "B", "C", "D", "s0")
        o, sf = selective_scan_cp(x["x"], x["dt"], x["A"], x["B"], x["C"], x["D"], x["s0"],
                                  x.get("reset"), group=group)
    loss = (o * x["do"]).sum() + (sf * torch.from_numpy(dsf_all[r])).sum()
    grads = torch.autograd.grad(loss, [x[k] for k in leaves])
    return {"o": _np(o), "s_final": _np(sf), **{f"d{k}": _np(g) for k, g in zip(leaves, grads)}}


# ----------------------------------------------------------- training
def tiny_cfg(kind: str, cp: bool):
    """``lina_gla_tiny`` cut to one mixer layer a side and one text layer
    (the blind cross-attention's pos_net kept), short convs on, backbone
    ``kind``, ``cp_axis="cp"`` where ``cp``."""
    from lina_speech_tpu_torch.config import lina_gla_tiny

    cfg = lina_gla_tiny()
    extra = {"rwkv6": dict(kind="rwkv6"), "mamba": dict(kind="mamba"), "gla": {}}[kind]
    bb = dataclasses.replace(cfg.backbone, n_layer=1, use_short_conv=True, **extra,
                             cp_axis="cp" if cp else None)
    te = dataclasses.replace(cfg.text_encoder, n_layers=1)
    return dataclasses.replace(cfg, backbone=bb, text_encoder=te)


def train_step(kind: str, state_dict: dict, batch: dict, dp: int, cp: int):
    """The tiny ``kind`` model carrying ``state_dict`` trains one step at dp
    x cp on this rank's part of ``batch``: its metrics and every parameter
    gradient the optimizer sees (after the sum over the ranks)."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh, shard_batch
    from lina_speech_tpu_torch.train import harness

    mesh = make_mesh(MeshConfig(dp=dp, cp=cp))
    model = build_model(tiny_cfg(kind, cp > 1), device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state = harness.create_train_state(model, harness.TrainConfig(n_warmup_steps=0,
                                                                  n_training_steps=10))
    grads = {}
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {n: _np(p.grad) for n, p in model.named_parameters()}))
    local = harness.batch_to_device(shard_batch(batch, mesh), "cpu")
    _, metrics = harness.make_train_step(model)(state, local)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads}


def fit(argv: list):
    """``train.cli fit`` with ``argv`` on this rank; the step it ended at."""
    from lina_speech_tpu_torch.train import cli

    return cli.main(argv).step


def codec_gan_step(audio: np.ndarray, dp: int, cp: int):
    """One discriminator and one generator step of the tiny codec GAN,
    data-parallel over this rank's dp line of a dp x cp mesh, on its rows of
    ``audio``: :func:`codec_gan_reference`'s results."""
    from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh, process_batch_slice

    mesh = make_mesh(MeshConfig(dp=dp, cp=cp))
    rows = process_batch_slice(audio.shape[0], mesh.index("dp"), dp)
    return codec_gan_reference(torch.from_numpy(audio[rows]), mesh.group("dp"))


def codec_gan_reference(audio: torch.Tensor, group=None):
    """The tiny codec GAN seeded with 0 (MPD of period 2, MRD of one
    resolution), one discriminator and one generator step on ``audio`` (averaged over the dp ``group``): {"grads": {optimizer:
    parameter name: the gradient its update took}, "metrics": {name:
    float}}."""
    from lina_speech_tpu_torch.codec.discriminators import (
        MultiPeriodDiscriminator, MultiResolutionDiscriminator,
    )
    from lina_speech_tpu_torch.codec.gan import (
        CodecGanConfig, create_codec_gan, make_codec_gan_steps,
    )
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizer
    from lina_speech_tpu_torch.train.codec_cli import codec_config

    cfg = CodecGanConfig()
    wavtok = WavTokenizer(codec_config(True))
    # one period and one resolution: the steps' code, at a fifth of MPD's size
    mpd = MultiPeriodDiscriminator(periods=(2,))
    mrd = MultiResolutionDiscriminator(resolutions=((512, 128),))
    state, gs, ds = create_codec_gan(torch.Generator().manual_seed(0), wavtok, mpd, mrd, cfg)
    disc_step, gen_step = make_codec_gan_steps(gs, ds, cfg, group)
    grads = {}
    for tag, opt, mods in (("disc", state.disc_opt, (("mpd", mpd), ("mrd", mrd))),
                           ("gen", state.gen_opt, (("gen", wavtok),))):
        opt.register_step_pre_hook(lambda *_, tag=tag, mods=mods: grads.update(
            {f"{tag}:{m}.{n}": _np(p.grad) for m, mod in mods for n, p in mod.named_parameters()}))
    state, dm = disc_step(state, audio)
    state, gm = gen_step(state, audio)
    return {"grads": grads, "metrics": {k: float(v) for k, v in {**dm, **gm}.items()}}


def vq_update(lat: np.ndarray, embed: np.ndarray, cluster_size: np.ndarray, dp: int, cp: int):
    """The VQ's EMA update and dead-code expiry over this rank's dp line, on
    its rows of the latents ``lat`` (b, t, d)."""
    from lina_speech_tpu_torch.codec import vq
    from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh, process_batch_slice

    mesh = make_mesh(MeshConfig(dp=dp, cp=cp))
    group = mesh.group("dp")
    x = torch.from_numpy(lat[process_batch_slice(lat.shape[0], mesh.index("dp"), dp)])
    q = vq.VQState(embed=torch.from_numpy(embed), cluster_size=torch.from_numpy(cluster_size),
                   embed_avg=torch.from_numpy(embed).clone())
    step = vq.vq_train_step(x, q, n_q=embed.shape[0], group=group)
    expired = vq.expire_dead_codes(torch.Generator().manual_seed(1), q, x, group=group)
    return {"embed": _np(step.quantizer.embed), "cluster_size": _np(step.quantizer.cluster_size),
            "embed_avg": _np(step.quantizer.embed_avg), "expired": _np(expired.embed)}


def replicated(perturb_rank: int):
    """``assert_replicated`` on the tiny model over the world, then again
    with one parameter of ``perturb_rank`` moved: (passed, error message)."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.parallel.checks import assert_replicated

    model = build_model(lina_gla_tiny(), device="cpu", seed=0)
    assert_replicated(model, dist.group.WORLD)
    if dist.get_rank() == perturb_rank:
        with torch.no_grad():
            model.attentive_rnn.decoder[1].cmix.p_out.weight[0, 0] += 1e-3
    try:
        assert_replicated(model, dist.group.WORLD)
    except AssertionError as err:
        return str(err)
    return None


CASES = {f.__name__: f for f in (cp_op, train_step, fit, codec_gan_step, vq_update, replicated)}
