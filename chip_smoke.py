#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from lina_speech_tpu_torch/csrc (nvcc, sm_90a);
3. kernel phase: each kernel against its plain PyTorch version at the
   flagship shapes (b 8 and 1, h 4, dk 256, dv 512, t 151, bf16 IO, bf16
   and f32 state), max error beside its tolerance, and both times;
4. slice phase: the flagship Lina-GLA (359,302,978 parameters, random
   weights from seed 0, bf16 compute and state) serves 8 requests through
   generate_batch (32 text tokens and a 150-code prompt each, top-k 100,
   400 steps); the kernel launch counts of that run are checked (25 per
   prefill, 25 per decode step); then the prefill and 16 decode steps are
   teacher-forced through the kernel path and the plain path, and their
   logits and times compared.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# flagship shapes
H, DK, DV, T_PROMPT, TEXT_LEN = 4, 256, 512, 150, 32
BATCH, MAX_SEQLEN, TOPK, TF_STEPS = 8, 400, 100, 16
N_GLA_LAYERS = 25
N_PARAMS = 359_302_978
# Kernel vs plain tolerances, relative to max(1, max|plain|): bf16 outputs
# agree to about one bf16 ulp (2**-8) once f32 summation order and the
# rounding of the 4-tap conv sums differ; f32 states to f32 summation order.
TOL_BF16, TOL_F32 = 1e-2, 1e-3
# teacher-forced logits, kernel path vs plain path through 25 bf16 layers
TOL_LOGITS = 5e-2
DEVICE = "cuda"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def eager_ms(fn, iters, warmup=2):
    """ms per call of ``fn`` run eagerly back to back, from CUDA events:
    device time, or host dispatch time where the host cannot keep up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so host launch cost is excluded."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def timed_pair(name, kernel_fn, plain_fn, iters):
    """Device and eager ms of a kernel and its plain version, in turns
    (plain, kernel, kernel, plain); returns the mean device ms of each."""
    dev = {"kernel": [], "plain": []}
    eager = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        dev[which].append(device_ms(fn, iters))
        eager[which].append(eager_ms(fn, iters))
    mean = lambda xs: sum(xs) / len(xs)
    print(f"  {name} device ms: kernel {dev['kernel']}, plain {dev['plain']}")
    print(f"  {name} eager ms (host dispatch included): kernel {eager['kernel']}, "
          f"plain {eager['plain']}")
    return mean(dev["kernel"]), mean(dev["plain"])


def ptxas_summary(log: str):
    """ptxas register / spill lines of the instantiations the main path
    launches (bf16 IO, bf16 state, head key dim 256)."""
    name, out = "", []
    for line in log.splitlines():
        if "entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split("for")[-1].strip()
            continue
        if "Li256E" in name and "13__nv_bfloat16S1_" in name and (
                "registers" in line or "spill" in line):
            kernel = "gla_chunk_conv" if "chunk" in name else "gla_decode_conv"
            out.append(f"{kernel}<bf16, bf16, 256>: {line.split(':', 1)[-1].strip()}")
    return out


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(ref, rel) -> float:
    return rel * max(1.0, float(ref.float().abs().max()))


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check(name, err, tol):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {status}")
    if err > tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


def kernel_inputs(torch, b, t, state_dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    gk = torch.nn.functional.logsigmoid(r(b, H, t, DK)) / 16
    return dict(
        xq=r(b, H, t, DK).to(bf), xk=r(b, H, t, DK).to(bf), xv=r(b, H, t, DV).to(bf),
        gk=gk, wq=(r(H * DK, 4) * 0.5).to(bf), wk=(r(H * DK, 4) * 0.5).to(bf),
        wv=(r(H * DV, 4) * 0.5).to(bf), s0=r(b, H, DK, DV).to(state_dtype),
        rings=[r(4, b, H, d).to(bf) for d in (DK, DK, DV)])


def kernel_phase(torch, gla_cuda):
    """Each kernel vs its plain version; returns the b8 bf16-state numbers."""
    t = T_PROMPT + 1
    summary = {}
    for b in (8, 1):
        for st in (torch.bfloat16, torch.float32):
            tag = f"b{b} state {str(st).split('.')[-1]}"
            x = kernel_inputs(torch, b, t, st, seed=b)
            chunk_args = (x["xq"], x["xk"], x["xv"], x["gk"], x["wq"], x["wk"], x["wv"])
            o_k, s_k = gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"])
            o_p, s_p = gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"])
            torch.cuda.synchronize()
            tol_s = TOL_BF16 if st == torch.bfloat16 else TOL_F32
            print(f"gla_chunk_conv {tag} t{t}:")
            err_o = max_err(o_k, o_p)
            check("o", err_o, bound(o_p, TOL_BF16))
            check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
            ms, plain_ms = timed_pair(
                "gla_chunk_conv",
                lambda: gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"]),
                lambda: gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"]),
                10)
            if b == BATCH and st == torch.bfloat16:
                summary["gla_chunk_conv"] = dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms)

            # decode: one token from the prefill's state (JAX layouts)
            dec = (x["xq"][:, :, 0].contiguous(), x["xk"][:, :, 0].contiguous(),
                   x["xv"][:, :, 0].contiguous(), x["gk"][:, :, 0].contiguous(),
                   *(w.reshape(H, -1, 4).permute(2, 0, 1).contiguous()
                     for w in (x["wq"], x["wk"], x["wv"])),
                   *x["rings"])
            out_p = gla_cuda.gla_decode_conv_plain(*dec, s_p)
            s_in = s_p.clone()
            out_k = gla_cuda.gla_decode_conv(*dec, s_in)
            torch.cuda.synchronize()
            require(out_k[1].data_ptr() == s_in.data_ptr(), "state not updated in place")
            print(f"gla_decode_conv {tag}:")
            err_o = max_err(out_k[0], out_p[0])
            check("o", err_o, bound(out_p[0], TOL_BF16))
            check("state", max_err(out_k[1], out_p[1]), bound(out_p[1], tol_s))
            for name, a, p in zip(("ring q", "ring k", "ring v"), out_k[2:], out_p[2:]):
                check(name, max_err(a, p), 0.0)
            state = s_p.clone()
            ms, plain_ms = timed_pair(
                "gla_decode_conv",
                lambda: gla_cuda.gla_decode_conv(*dec, state),
                lambda: gla_cuda.gla_decode_conv_plain(*dec, state), 50)
            if b == BATCH and st == torch.bfloat16:
                summary["gla_decode_conv"] = dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms)
    return summary


def set_kernel_mode(model, mode):
    for layer in model.attentive_rnn.gla_layers():
        layer.kernel_mode = mode


def slice_phase(torch, np, gla_cuda, card_line):
    from lina_speech_tpu_torch.config import build_model, lina_gla_169m
    from lina_speech_tpu_torch.generate import cut_outputs, generate_batch

    cfg = lina_gla_169m(compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, state_dtype="bfloat16"))
    model = build_model(cfg, device=DEVICE, seed=0).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flagship lina_gla_169m: {n_params:,} parameters")
    require(n_params == N_PARAMS, f"{n_params} parameters, expected {N_PARAMS}")
    require(len(model.attentive_rnn.gla_layers()) == N_GLA_LAYERS, "GLA layer count")

    rng = np.random.default_rng(0)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook, size=(1, BATCH, T_PROMPT))).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    torch.cuda.synchronize()
    gla_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, gen, prompt=prompt, max_seqlen=MAX_SEQLEN, k=TOPK,
                         force_max_seqlen=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gla_cuda.launch_counts()
    n_pre = T_PROMPT + 1
    steps = res.n_steps - n_pre
    print(f"generate_batch: {BATCH} requests, {res.n_steps} steps ({steps} decoded), "
          f"{wall:.3f} s wall [{card_line}]")
    print(f"launches: {launches} (expected {N_GLA_LAYERS} chunk, "
          f"{N_GLA_LAYERS * steps} decode)")
    require(launches["gla_chunk_conv"] == N_GLA_LAYERS, f"launches {launches}")
    require(launches["gla_decode_conv"] == N_GLA_LAYERS * steps, f"launches {launches}")
    toks = res.tokens
    require(toks.shape == (cfg.n_quant, BATCH, MAX_SEQLEN), f"tokens {tuple(toks.shape)}")
    require(int(toks.min()) >= 0 and int(toks.max()) < model.n_target_vocab,
            "tokens out of range")
    cuts = cut_outputs(res, cfg.n_quant)
    print(f"tokens in range; cut lengths {[c[0].shape[-1] for c in cuts]}")

    # teacher-forced prefill + TF_STEPS decode steps, kernel path vs plain
    with torch.no_grad():
        x_enc = model.encode_text(text)
        start = model.embed_tokens(torch.ones(1, BATCH, 1, dtype=torch.long, device=DEVICE))
        forced = torch.cat([start, model.embed_tokens(prompt + cfg.n_special_token_in)], 1)
        follow = model.embed_tokens(toks[:, :, n_pre:n_pre + TF_STEPS])
        results = {}
        for mode in ("auto", "chunk", "chunk", "auto"):
            set_kernel_mode(model, mode)
            logits_pre, _, st = model.prefill(forced, x_enc, model.empty_state(BATCH, DEVICE))
            logits = [logits_pre[:, -1]]
            for i in range(TF_STEPS):
                lg, _, st = model.decode_step(follow[:, i], x_enc, st, time_step=n_pre + i)
                logits.append(lg)
            pre_ms = eager_ms(lambda: model.prefill(
                forced, x_enc, model.empty_state(BATCH, DEVICE)), 3, warmup=1)

            def decode_steps():
                s = model.prefill(forced[:, :8], x_enc, model.empty_state(BATCH, DEVICE))[2]
                torch.cuda.synchronize()
                t_0 = time.perf_counter()
                for i in range(TF_STEPS):
                    s = model.decode_step(follow[:, i], x_enc, s)[2]
                torch.cuda.synchronize()
                return (time.perf_counter() - t_0) * 1e3 / TF_STEPS

            decode_steps()
            dec_ms = decode_steps()
            results.setdefault(mode, dict(logits=torch.stack(logits, 1), pre=[], dec=[]))
            results[mode]["pre"].append(pre_ms)
            results[mode]["dec"].append(dec_ms)
        set_kernel_mode(model, "auto")
    ref = results["chunk"]["logits"]
    err = max_err(results["auto"]["logits"], ref)
    agree = float((results["auto"]["logits"].argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"teacher-forced logits (prefill + {TF_STEPS} steps), kernel vs plain path:")
    check("logits", err, bound(ref, TOL_LOGITS))
    print(f"  argmax agreement {agree:.4f}")
    for mode, name in (("auto", "kernel"), ("chunk", "plain")):
        r = results[mode]
        print(f"{name} path: prefill b{BATCH} t{n_pre} {r['pre']} ms, decode "
              f"{r['dec']} ms/token (b{BATCH}) [{card_line}]")
    profile_decode(torch, model, x_enc, forced, follow)
    return launches


def profile_decode(torch, model, x_enc, forced, follow, steps=8):
    """Device busy share and top kernels of the kernel path's decode steps
    under torch.profiler (the profiler's own overhead included)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        st = model.prefill(forced[:, :8], x_enc, model.empty_state(BATCH, DEVICE))[2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                st = model.decode_step(follow[:, i], x_enc, st)[2]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # kernel and memcpy rows only: CPU-op rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    if not events:
        print("profiler: no device time recorded; device busy share not measured")
        return
    print(f"profiler, {steps} decode steps b{BATCH}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f} of wall)")
    for e in sorted(events, key=dev, reverse=True)[:8]:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on a GPU only")
    from lina_speech_tpu_torch.ops import _build, gla_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    path = _build.build()
    _build.load_library()
    built = (f"built by nvcc in {_build.build_seconds:.2f} s"
             if _build.build_seconds is not None else "reused from an earlier build")
    print(f"kernels {built}: {os.path.relpath(path, ROOT)}")
    for line in ptxas_summary(_build.build_log):
        print(f"  ptxas {line}")

    summary = kernel_phase(torch, gla_cuda)
    launches = slice_phase(torch, np, gla_cuda, card_line)
    kernels = []
    for name, source, replaces in (
            ("gla_chunk_conv", "lina_speech_tpu_torch/csrc/gla_chunk_conv.cu",
             "lina_speech_tpu/ops/gla_pallas.py:1289"),
            ("gla_decode_conv", "lina_speech_tpu_torch/csrc/gla_decode_conv.cu",
             "lina_speech_tpu/ops/gla_pallas.py:1641")):
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **summary[name]))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
