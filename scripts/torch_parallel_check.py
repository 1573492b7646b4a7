#!/usr/bin/env python3
"""Data and context parallelism across cards on NCCL: what the one-card
``chip_smoke.py`` cannot hold.

    torchrun --nproc-per-node 4 scripts/torch_parallel_check.py

The same command runs on the CPU with gloo (``--device cpu``, tiny widths,
the plain versions of the kernels) as a rehearsal. Every rank:

1. the context-parallel ops at cp = the world size on the kernels, each rank
   its time shard of one seeded b2 t512 sequence (``ops/gla_cp.py:
   gla_chunk_cp`` for the flagship GLA layer, h4 dk256 dv512 bf16, and for
   Mamba-2, h32 dk64 dv64 f32 IO; ``rwkv6_chunk_cp``, h4 dk256 dv256 bf16;
   ``ops/mamba_cp.py:selective_scan_cp``, d2048 n16 bf16), forward and
   backward with a cotangent of the final state on every rank, against the
   single-device kernel path on the whole sequence (every rank computes it):
   outputs and final states within ``TOL_STATE`` of max|ref|, each input
   gradient within ``TOL_GRAD`` and u, A, D (summed over the ranks) within
   ``TOL_PARAM_GRAD``, chip_smoke.py's tolerances; the ms of one op's
   forward and backward and of its pairs' all_gather (CUDA events);
2. the flagship's width at dp 2 x cp 2 (world 4; 2 layers a side, f32
   compute so the comparison is tight) one train step on a b4 t256 batch
   against one rank's single-process step on the whole batch: the loss
   (rtol 1e-4) and every parameter gradient (``TOL_F32`` of its own
   max|ref|; the softmax key-side biases, zero in exact arithmetic, left
   out);
3. the full flagship in bf16 at dp 2 x cp 2 against dp 4 (world 4), b8 t512
   from the seeded synthetic batches: warm ms a step (host clock around a
   synchronised step, the median of 3) and the ms of the gradient
   all_reduce alone.

Prints one JSON line per part from rank 0 and exits non-zero on a miss.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL_STATE, TOL_GRAD, TOL_PARAM_GRAD, TOL_F32 = 1e-1, 2e-2, 3e-2, 1e-3
PARAMS = ("u", "A", "D")


def _max_share(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def cp_inputs(torch, kind, device, tiny, gen):
    """The leaves and cotangents of one op's case (the whole sequence)."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=device)
    b, t = 2, (64 if tiny else 512)
    reset = torch.zeros(b, t, dtype=torch.bool, device=device)
    reset[1, t * 3 // 5] = True
    if kind == "mamba":
        d, n = (64 if tiny else 2048), 16
        io = torch.float32 if tiny else torch.bfloat16
        x = dict(x=rn(b, t, d).to(io), dt=torch.nn.functional.softplus(rn(b, t, d) - 4.0),
                 A=-torch.exp(torch.log(torch.arange(1.0, n + 1, device=device)) + 0.1 * rn(d, n)),
                 B=rn(b, t, n).to(io), C=rn(b, t, n).to(io), D=1.0 + 0.1 * rn(d))
        return x, reset, rn(b, t, d).to(io), rn(b, d, n)
    h, dk, dv = {"gla": (4, 256, 512), "rwkv6": (4, 256, 256), "mamba2": (32, 64, 64)}[kind]
    if tiny:
        h, dk, dv = 2, 16, 16
    io = torch.float32 if kind == "mamba2" or tiny else torch.bfloat16
    gate = {"gla": lambda: torch.nn.functional.logsigmoid(rn(b, h, t, dk)) / 16,
            "rwkv6": lambda: -torch.exp(0.5 * rn(b, h, t, dk) - 2.5),
            "mamba2": lambda: (-torch.nn.functional.softplus(rn(b, h, t, 1) - 3.0)
                               ).expand(b, h, t, dk)}[kind]()
    gate = gate.masked_fill(reset[:, None, :, None], -20.0).contiguous()
    x = dict(q=rn(b, h, t, dk).to(io), k=(rn(b, h, t, dk) * dk ** -0.5).to(io),
             v=rn(b, h, t, dv).to(io), gk=gate)
    if kind == "rwkv6":
        x["u"] = 0.5 * rn(h, dk)
    return x, reset, rn(b, h, t, dv).to(io), rn(b, h, dk, dv)


def run_op(torch, kind, leaves, reset, do, dsf, group):
    """(out, final state, gradients) of sum(out do) + sum(sf dsf) through
    the whole-sequence kernel call (``group`` None) or the CP op."""
    from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda, rwkv6_cuda
    from lina_speech_tpu_torch.ops.gla_cp import gla_chunk_cp, rwkv6_chunk_cp
    from lina_speech_tpu_torch.ops.mamba_cp import selective_scan_cp

    live = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    L = live
    if kind == "mamba":
        args = (L["x"], L["dt"], L["A"], L["B"], L["C"], L["D"])
        o, sf = (mamba_cuda.mamba_scan(*args, None, reset) if group is None else
                 selective_scan_cp(*args, None, reset, group=group, local=mamba_cuda.mamba_scan))
    elif kind == "rwkv6":
        args = (L["q"], L["k"], L["v"], L["gk"], L["u"])
        o, sf = (rwkv6_cuda.rwkv6_chunk(*args) if group is None else
                 rwkv6_chunk_cp(*args, group=group, local=rwkv6_cuda.rwkv6_chunk))
    else:
        scale = None if kind == "gla" else 1.0
        args = (L["q"], L["k"], L["v"], L["gk"])
        o, sf = (gla_cuda.gla_chunk(*args, scale=scale) if group is None else
                 gla_chunk_cp(*args, scale=scale, group=group, local=gla_cuda.gla_chunk))
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf).sum()
    grads = torch.autograd.grad(loss, list(live.values()))
    return o.detach(), sf.detach(), dict(zip(live, grads))


def part_ops(torch, dist, device, tiny):
    """Part 1 (module docstring); returns its record."""
    from lina_speech_tpu_torch.parallel.collectives import all_gather_grad
    from lina_speech_tpu_torch.parallel.sharding import time_shard

    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    record = {}
    for kind in ("gla", "rwkv6", "mamba", "mamba2"):
        gen = torch.Generator(device=device).manual_seed(970 + len(kind))
        leaves, reset, do, dsf_all = cp_inputs(torch, kind, device, tiny, gen)
        t_dim = 1 if kind == "mamba" else 2
        # the whole sequence on this rank, the final state's cotangent the
        # sum of every rank's (each rank's is dsf_all scaled by rank + 1)
        total = dsf_all * sum(range(1, world + 1))
        o_r, s_r, g_r = run_op(torch, kind, leaves, reset, do, total, None)
        shard = {k: (time_shard(v, world, rank, t_dim) if v.dim() >= 3 else v)
                 for k, v in leaves.items()}
        reset_s = time_shard(reset.float(), world, rank, 1).bool()
        do_s = time_shard(do, world, rank, t_dim)
        dsf = dsf_all * (rank + 1)
        o_c, s_c, g_c = run_op(torch, kind, shard, reset_s, do_s, dsf, group)
        worst = {"o": _max_share(o_c, time_shard(o_r, world, rank, t_dim)),
                 "final state": _max_share(s_c, s_r)}
        for name, g in g_c.items():
            if name in PARAMS:
                g = g.clone()
                dist.all_reduce(g, group=group)
                worst[f"d{name}"] = _max_share(g, g_r[name])
            else:
                worst[f"d{name}"] = _max_share(g, time_shard(g_r[name], world, rank, t_dim))
        tol = {k: TOL_STATE if k in ("o", "final state") else
               TOL_PARAM_GRAD if k[1:] in PARAMS else TOL_GRAD for k in worst}
        shares = torch.tensor([worst[k] for k in worst], device=device)
        dist.all_reduce(shares, op=dist.ReduceOp.MAX, group=group)
        worst = dict(zip(worst, shares.tolist()))
        # times: one op forward + backward on this rank's shard, and the
        # pairs' all_gather alone
        n_pair = (leaves["q"].shape[0] * leaves["q"].shape[1] * leaves["q"].shape[3]
                  * (leaves["v"].shape[3] + 1) if kind != "mamba"
                  else leaves["x"].shape[0] * leaves["x"].shape[2] * 16 * 2)
        pairs = torch.randn(n_pair, device=device)
        ms = {}
        for label, fn in (("op forward and backward", lambda: run_op(
                torch, kind, shard, reset_s, do_s, dsf, group)),
                          ("pairs all_gather", lambda: all_gather_grad(pairs, group))):
            for _ in range(2):
                fn()
            ms[label] = timed(torch, dist, device, fn, 5)
        record[kind] = {"worst": worst, "tol": tol, "ms": ms,
                        "ok": all(worst[k] <= tol[k] for k in worst)}
    return record


def timed(torch, dist, device, fn, iters) -> float:
    """ms a call of ``fn``: CUDA events on the card, the host clock on the
    CPU, after a barrier."""
    dist.barrier()
    if device.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def flagship_cfg(tiny, depth, compute):
    from lina_speech_tpu_torch.config import lina_gla_169m, lina_gla_tiny

    cfg = lina_gla_tiny() if tiny else lina_gla_169m()
    bb = dataclasses.replace(cfg.backbone, n_layer=depth or cfg.backbone.n_layer)
    return dataclasses.replace(cfg, backbone=bb, compute_dtype=compute)


def step_grads(torch, cfg, batch, device, mesh):
    """(loss, {name: gradient}) of one train step of ``cfg`` (seed 0) on
    this rank's part of ``batch``, at ``mesh`` (None: one process, the
    whole batch)."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.parallel import shard_batch
    from lina_speech_tpu_torch.train import harness

    if mesh is not None and mesh.size("cp") > 1:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, cp_axis="cp"))
    model = build_model(cfg, device=device, seed=0, mesh=mesh)
    state = harness.create_train_state(model, harness.TrainConfig(n_warmup_steps=0,
                                                                  n_training_steps=10))
    grads = {}
    state.optimizer.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    part = batch if mesh is None else shard_batch(batch, mesh)
    _, metrics = harness.make_train_step(model)(state, harness.batch_to_device(part, device))
    return float(metrics["loss"]), grads


def part_step(torch, dist, device, tiny):
    """Part 2 (module docstring); returns its record."""
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh

    cfg = flagship_cfg(tiny, 2, "float32")
    batch = next(synthetic_tts_batches(batch_size=4, n_quant=cfg.n_quant,
                                       n_codebook=cfg.n_codebook, min_audio_len=128,
                                       max_audio_len=256, seed=3))
    loss, grads = step_grads(torch, cfg, batch, device, make_mesh(MeshConfig(dp=2, cp=2)))
    record = {"loss": loss}
    if dist.get_rank() == 0:
        ref_loss, ref = step_grads(torch, cfg, batch, device, None)
        keyside = lambda n: n.endswith("ln_k.bias") or n.endswith("cross_att.k.bias")
        worst = max((_max_share(grads[n], ref[n]), n) for n in ref if not keyside(n))
        record.update(ref_loss=ref_loss, worst_grad=worst[0], worst_leaf=worst[1],
                      ok=abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) and worst[0] <= TOL_F32)
    return record


def part_wall(torch, dist, device, tiny):
    """Part 3 (module docstring); returns its record."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.parallel import MeshConfig, make_mesh, shard_batch
    from lina_speech_tpu_torch.parallel.collectives import all_reduce_grads_
    from lina_speech_tpu_torch.train import harness

    world = dist.get_world_size()
    record = {}
    for label, mc in ((f"dp {world}", MeshConfig(dp=world)),
                      ("dp 2 x cp 2", MeshConfig(dp=2, cp=world // 2))):
        cfg = flagship_cfg(tiny, None, "float32" if tiny else "bfloat16")
        mesh = make_mesh(mc)
        if mesh.size("cp") > 1:
            cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                        cp_axis="cp"))
        model = build_model(cfg, device=device, seed=0, mesh=mesh)
        state = harness.create_train_state(model, harness.TrainConfig(n_warmup_steps=2,
                                                                      n_training_steps=100))
        step = harness.make_train_step(model)
        data = synthetic_tts_batches(batch_size=8, n_quant=cfg.n_quant,
                                     n_codebook=cfg.n_codebook, min_audio_len=64 if tiny else 510,
                                     max_audio_len=64 if tiny else 510, seed=0)
        times = []
        for _ in range(4):
            batch = harness.batch_to_device(shard_batch(next(data), mesh), device)
            dist.barrier()
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        grads = [torch.zeros_like(p) for p in model.parameters()]
        reduce_ms = timed(torch, dist, device, lambda: all_reduce_grads_(grads, dist.group.WORLD),
                          3)
        record[label] = {"warm_step_ms": statistics.median(times[1:]),
                         "grad_all_reduce_ms": reduce_ms, "loss": float(metrics["loss"])}
        del model, state, grads
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo, tiny widths)")
    ap.add_argument("--parts", default="ops,step,wall")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist

    from lina_speech_tpu_torch.parallel import distributed_init
    from lina_speech_tpu_torch.parallel.multihost import local_device

    tiny = args.device == "cpu"
    device = local_device(args.device)
    distributed_init(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if tiny:
        torch.set_num_threads(1)
    else:  # one build, by each host's first rank, then every rank loads it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from lina_speech_tpu_torch.ops import _build

        if int(os.environ.get("LOCAL_RANK", "0")) == 0:
            _build.build()
        dist.barrier()
        _build.load_library()
    if world != 4:
        raise SystemExit(f"needs a world of 4 ranks (torchrun --nproc-per-node 4); got {world}")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ok = True
    for name, fn in (("ops", part_ops), ("step", part_step), ("wall", part_wall)):
        if name not in args.parts.split(","):
            continue
        t0 = time.perf_counter()
        record = fn(torch, dist, device, tiny)
        if rank == 0:
            print(json.dumps({"part": name, "world": world, "device": card,
                              "backend": dist.get_backend(),
                              "seconds": round(time.perf_counter() - t0, 1), **record}),
                  flush=True)
        ok &= all(v.get("ok", True) for v in record.values() if isinstance(v, dict)) and \
            record.get("ok", True)
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
