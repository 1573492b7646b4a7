#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from lina_speech_tpu_torch/csrc (nvcc, sm_90a);
3. kernel phase: each of the five kernels against its plain PyTorch version
   at the flagship shapes (h 4, dk 256, dv 512, bf16 IO, bf16 and f32
   state): the two prefill kernels at b 8 and 1 and t from 151 down to 1,
   every chunk length the server gives them at b 1 included,
   the classic decode step, the lazy-window step (b 8 and 64, window 16,
   stale garbage in the dead slots) and the window fold, and a whole lazy
   window against 16 classic steps; max error beside its tolerance, both
   times, and each kernel's roofline bound;
4. generate phase: the flagship Lina-GLA (359,302,978 parameters, random
   weights from seed 0, bf16 compute and state) serves 8 requests through
   generate_batch (32 text tokens and a 150-code prompt each, top-k 100,
   200 steps), first with the classic token loop, then with lazy_window=16;
   the kernel launch counts of each run are checked; then the prefill and
   16 decode steps are teacher-forced through the kernel path and the plain
   path, and their logits and times compared;
5. serving phase: DecodeServer with 8 slots and chunks of 16 serves 12
   requests (prompts of 150, 97, 33 and 0 codes, max_len 240-400, so slots
   are recycled) in lazy mode, then 8 requests in classic mode, one
   run(max_chunks=1) call at a time; completions, prefill chunk sizes (each
   one a shape the kernel phase checked) and launch counts are checked, the
   5-chunk prefill against the one-shot prefill, and the server's logits and
   final states on the kernel path against the plain path under teacher
   forcing, every state tensor within a share of its own magnitude.
Each main-path run starts with the launch counts at 0 and reads them right
after. The line before the last is a JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# flagship shapes
H, DK, DV, T_PROMPT, TEXT_LEN = 4, 256, 512, 150, 32
BATCH, MAX_SEQLEN, TOPK, TF_STEPS = 8, 200, 100, 16
WINDOW = 16  # lazy window == serving chunk
SERVE_SLOTS, SERVE_REQUESTS, SERVE_CLASSIC_REQUESTS, MAX_TEXT_LEN = 8, 12, 8, 64
SERVE_PROMPTS = (150, 97, 33, 0)
# chunk lengths at which the two prefill kernels are held against their plain
# versions at b1; the serving phase fails if the server ran any other length
CONV_CHUNK_T = (128, 64, 32, 1)
CHUNK_T = (151, 128, 64, 32, 16, 4, 2, 1)
N_GLA_LAYERS = 25
N_PARAMS = 359_302_978
# Kernel vs plain tolerances, relative to max(1, max|plain|): bf16 outputs
# agree to about one bf16 ulp (2**-8) once f32 summation order and the
# rounding of the 4-tap conv sums differ; f32 states to f32 summation order.
TOL_BF16, TOL_F32 = 1e-2, 1e-3
# teacher-forced logits, kernel path vs plain path through 25 bf16 layers
TOL_LOGITS = 5e-2
# A state leaf of one model run against the same leaf of another run, relative
# to that leaf's own max|reference| with no floor, so a leaf of zeros fails.
# Kernel path vs plain path runs the same shapes and is held to TOL_BF16. A
# chunked prefill vs the one-shot prefill is held to TOL_STATE: its GEMMs have
# other shapes, so the bf16 hidden stream differs by a few ulps and the leaves
# of the late layers with it (an H100 reads 3.4e-2 at worst).
TOL_STATE = 1e-1
DEVICE = "cuda"
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12
KERNELS = (  # name, source, the TPU kernel it replaces
    ("gla_chunk_conv", "lina_speech_tpu_torch/csrc/gla_chunk_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1289"),
    ("gla_chunk", "lina_speech_tpu_torch/csrc/gla_chunk.cu",
     "lina_speech_tpu/ops/gla_pallas.py:699"),
    ("gla_decode_conv", "lina_speech_tpu_torch/csrc/gla_decode_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1641"),
    ("gla_decode_lazy_conv", "lina_speech_tpu_torch/csrc/gla_decode_lazy_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2197"),
    ("gla_fold", "lina_speech_tpu_torch/csrc/gla_fold.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2232"))


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


def cold_pool(state):
    """A callable that hands out copies of ``state`` in turn, twice the
    50 MB L2 cache in all: the model cycles through 25 layers' states, so a
    decode kernel finds its state in device memory, not in the cache. Timing
    one state over and over would measure the cache."""
    n = max(2, -(-100_000_000 // (state.numel() * state.element_size())))
    pool = itertools.cycle([state.clone() for _ in range(n)])
    return lambda: next(pool)


def ptxas_summary(log: str):
    """ptxas register / spill lines of the instantiations the main path
    launches (bf16 IO, bf16 state, head key dim 256)."""
    labels = (("gla_decode_lazy_conv_kernel", "gla_decode_lazy_conv"),
              ("gla_decode_conv_kernel", "gla_decode_conv"),
              ("gla_fold_kernel", "gla_fold"), ("Lb1E", "gla_chunk_conv"),
              ("Lb0E", "gla_chunk"))
    name, out = "", []
    for line in log.splitlines():
        if "entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split("for")[-1].strip()
            continue
        if re.search(r"I13__nv_bfloat16S\d*_Li256E", name) and (
                "registers" in line or "spill" in line):
            kernel = next((label for key, label in labels if key in name), name)
            out.append(f"{kernel}<bf16, bf16, 256>: {line.split(':', 1)[-1].strip()}")
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes, flops, io_dtype):
    """(bound_ms, bound_by): the least time one H100 could take -- the
    bytes of every input read once and every output written once over the
    card's memory rate, or the function's operations over the card's peak
    rate for the inputs' type (bf16: tensor cores; f32: outside them),
    whichever is larger."""
    import torch

    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / (PEAK_BF16 if io_dtype == torch.bfloat16 else PEAK_F32)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def scan_flops(b, t, conv):
    """Operations of the GLA recurrence over t tokens: per token and head a
    decay, a rank-1 update and a readout of the (DK x DV) state (5 DK DV),
    plus the 4-tap convs of q, k and v where the kernel has them."""
    return b * H * t * (5 * DK * DV + (8 * (2 * DK + DV) if conv else 0))


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(ref, rel) -> float:
    return rel * max(1.0, float(ref.float().abs().max()))


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check(name, err, tol):
    ok = err <= tol  # False for a NaN
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


def state_leaves(state):
    """(field, place, tensor) of every tensor of a BackboneState."""
    places = [(f"layer {i}", st) for i, st in enumerate(state.layers)]
    if state.pos_net is not None:
        places.append(("pos_net", state.pos_net))
    return [(f.name, place, getattr(st, f.name)) for place, st in places
            for f in dataclasses.fields(st) if getattr(st, f.name) is not None]


def check_states(name, got, ref, rel, live):
    """Every tensor of BackboneState ``got`` against ``ref``, each within
    ``rel`` of that leaf's own max|ref| (no floor). The fields named in
    ``live`` must hold something: max|ref| > 0. Prints, for each field, the
    leaf with the largest error beside its max|ref|; fails after printing."""
    worst, failed = {}, []
    for (field, place, a), (_, _, r) in zip(state_leaves(got), state_leaves(ref)):
        require(a.shape == r.shape and a.dtype == r.dtype, f"{name}: {place} {field} differs "
                f"in shape or dtype: {tuple(a.shape)} {a.dtype} vs {tuple(r.shape)} {r.dtype}")
        err, ref_max = max_err(a, r), float(r.float().abs().max())
        if field in live and not ref_max > 0:
            failed.append(f"{place} {field}: reference is all zeros")
        if not err <= rel * ref_max:
            failed.append(f"{place} {field}: max_abs_err {err} > {rel * ref_max}")
        if field not in worst or err / max(ref_max, 1e-30) > worst[field][0]:
            worst[field] = (err / max(ref_max, 1e-30), err, ref_max, place)
    print(f"{name}, per field the leaf with the largest error relative to its max|ref| "
          f"(tolerance {rel:.1e} of max|ref|):")
    for field, (share, err, ref_max, place) in worst.items():
        print(f"  {field} ({place}): max_abs_err {err:.3e}, max|ref| {ref_max:.3e}, "
              f"relative {share:.3e}")
    require(not failed, f"{name}: " + "; ".join(failed[:8]))
    print(f"  {len(state_leaves(ref))} leaves ok")


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


def record(summary, name, err, ms, plain_ms, n_bytes, flops, io_dtype):
    bound_ms, bound_by = roofline(n_bytes, flops, io_dtype)
    print(f"  {name} bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} bytes, {flops} operations); kernel {ms:.6f} ms")
    # no single PyTorch call computes any of these functions: no library time
    summary[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)


def kernel_phase(torch, gla_cuda):
    """The conv-fused prefill kernel and the classic decode step vs their
    plain versions at generate_batch's shapes (t 151, b 8 and 1), then the
    prefill kernel at the server's first-chunk shapes (b1, CONV_CHUNK_T);
    records the b8 bf16-state numbers in the summary."""
    t = T_PROMPT + 1
    bf = torch.bfloat16
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
                record(summary, "gla_chunk_conv", err_o, ms, plain_ms,
                       nbytes(*chunk_args, x["s0"], o_k, s_k), scan_flops(b, t, True), bf)

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
            warm_ms = device_ms(lambda: gla_cuda.gla_decode_conv(*dec, state), 50)
            print(f"  gla_decode_conv on one state over and over (warm L2): device ms "
                  f"{warm_ms:.6f}")
            states = cold_pool(s_p)
            ms, plain_ms = timed_pair(
                "gla_decode_conv",
                lambda: gla_cuda.gla_decode_conv(*dec, states()),
                lambda: gla_cuda.gla_decode_conv_plain(*dec, states()), 50)
            if b == BATCH and st == torch.bfloat16:
                # state read and written; every other input and output once
                record(summary, "gla_decode_conv", err_o, ms, plain_ms,
                       nbytes(*dec, state, *out_k), scan_flops(b, 1, True), bf)

    # a served prompt's first chunk: b1, a power of two down to a single token
    for st in (torch.bfloat16, torch.float32):
        tol_s = TOL_BF16 if st == torch.bfloat16 else TOL_F32
        for t in CONV_CHUNK_T:
            x = kernel_inputs(torch, 1, t, st, seed=200 + t)
            chunk_args = (x["xq"], x["xk"], x["xv"], x["gk"], x["wq"], x["wk"], x["wv"])
            o_k, s_k = gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"])
            o_p, s_p = gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"])
            torch.cuda.synchronize()
            require(o_k.dtype == bf and s_k.dtype == st, "gla_chunk_conv output dtypes")
            print(f"gla_chunk_conv b1 state {str(st).split('.')[-1]} t{t}:")
            check("o", max_err(o_k, o_p), bound(o_p, TOL_BF16))
            check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
            if st == bf and t in (128, 1):
                timed_pair(
                    f"gla_chunk_conv b1 t{t}",
                    lambda: gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"]),
                    lambda: gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"]),
                    10)
    return summary


def chunk_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk (post-conv q, k, v; non-zero initial state) vs its plain
    version at every length of CHUNK_T, t = 151 down to a single token. The
    summary takes the serving prefill's largest chunk: b1, t128, bf16 state."""
    bf = torch.bfloat16
    for b in (1, 8):
        for st in (torch.bfloat16, torch.float32):
            tol_s = TOL_BF16 if st == torch.bfloat16 else TOL_F32
            for t in CHUNK_T:
                x = kernel_inputs(torch, b, t, st, seed=100 + t)
                args = (x["xq"], x["xk"], x["xv"], x["gk"])
                o_k, s_k = gla_cuda.gla_chunk(*args, initial_state=x["s0"])
                o_p, s_p = gla_cuda.gla_chunk_plain(*args, initial_state=x["s0"])
                torch.cuda.synchronize()
                require(o_k.dtype == bf and s_k.dtype == st, "gla_chunk output dtypes")
                print(f"gla_chunk b{b} state {str(st).split('.')[-1]} t{t}:")
                err_o = max_err(o_k, o_p)
                check("o", err_o, bound(o_p, TOL_BF16))
                check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
                if b == 1 and st == bf and t in (128, 1):
                    ms, plain_ms = timed_pair(
                        f"gla_chunk t{t}",
                        lambda: gla_cuda.gla_chunk(*args, initial_state=x["s0"]),
                        lambda: gla_cuda.gla_chunk_plain(*args, initial_state=x["s0"]), 10)
                    if t == 128:
                        record(summary, "gla_chunk", err_o, ms, plain_ms,
                               nbytes(*args, x["s0"], o_k, s_k), scan_flops(b, t, False), bf)


def lazy_inputs(torch, b, st, seed):
    """One window of decode tokens in the JAX layouts, and window buffers
    whose every slot holds stale garbage: a large positive cbuf overflows an
    exp that is not clamped, and a slot that is not masked shows in o."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    toks = [(r(b, H, DK).to(bf), r(b, H, DK).to(bf), r(b, H, DV).to(bf),
             torch.nn.functional.logsigmoid(r(b, H, DK)) / 16) for _ in range(WINDOW)]
    taps = [(r(4, H, d) * 0.5).to(bf) for d in (DK, DK, DV)]
    rings = [r(4, b, H, d).to(bf) for d in (DK, DK, DV)]
    bufs = [(r(WINDOW, b, H, DK) * 9).to(bf), (r(WINDOW, b, H, DV) * 9).to(bf),
            torch.full((WINDOW, b, H, DK), 200.0, device=DEVICE),
            torch.zeros(b, H, DK, device=DEVICE)]
    return toks, taps, rings, r(b, H, DK, DV).to(st), bufs


def lazy_kernel_phase(torch, gla_cuda, summary):
    """A whole lazy window at b8 and b64: every step of gla_decode_lazy_conv
    against its plain version (slot p written in place, dead slots ignored),
    gla_fold against its plain version, and the window against 16 classic
    gla_decode_conv_plain steps (the lazy recurrence is the classic one)."""
    bf = torch.bfloat16
    for b in (8, 64):
        for st in (torch.bfloat16, torch.float32):
            tag = f"b{b} state {str(st).split('.')[-1]}"
            tol_s = TOL_BF16 if st == bf else TOL_F32
            toks, taps, rings, s0, bufs = lazy_inputs(torch, b, st, seed=b)
            k_rings = p_rings = c_rings = rings
            k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
            c_state = s0.clone()
            timed, states = {}, cold_pool(s0)
            for p, tok in enumerate(toks):
                ptrs = [t.data_ptr() for t in k_bufs[:3]]
                if p in (0, 7, 15) and st == bf:  # time the step before taking it
                    scratch = [t.clone() for t in k_bufs]
                    timed[p] = timed_pair(
                        f"gla_decode_lazy_conv {tag} p{p}",
                        lambda: gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, states(),
                                                              *scratch, p),
                        lambda: gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *k_rings,
                                                                    states(), *scratch, p), 50)
                out = gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, s0, *k_bufs, p)
                ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, s0, *p_bufs, p)
                cls = gla_cuda.gla_decode_conv_plain(*tok, *taps, *c_rings, c_state)
                torch.cuda.synchronize()
                require([t.data_ptr() for t in out[4:7]] == ptrs,
                        "window buffers not written in place")
                if p in (0, 7, 15):
                    print(f"gla_decode_lazy_conv {tag} p{p}:")
                    err_o = max_err(out[0], ref[0])
                    check("o", err_o, bound(ref[0], TOL_BF16))
                    check("o vs classic step", max_err(out[0], cls[0]), bound(cls[0], TOL_LOGITS))
                    for name, a, r_ in zip(("ring q", "ring k", "ring v"), out[1:4], ref[1:4]):
                        check(name, max_err(a, r_), 0.0)
                    for name, a, r_ in zip(("kbuf", "vbuf", "cbuf"), out[4:7], ref[4:7]):
                        check(f"{name}[:p+1]", max_err(a[:p + 1], r_[:p + 1]),
                              bound(r_[:p + 1], TOL_BF16 if a.dtype == bf else 1e-6))
                    check("cc", max_err(out[7], ref[7]), bound(ref[7], 1e-6))
                    if p in timed and b == BATCH and p == WINDOW - 1:
                        # the live slots j < p are read, slot p is written
                        moved = nbytes(*tok, *taps, *k_rings, s0, k_bufs[3], out[0], *out[1:4],
                                       out[7]) + nbytes(*(t[:p + 1] for t in k_bufs[:3]))
                        flops = b * H * (2 * DK * DV + (p + 1) * (3 * DK + 2 * DV)
                                         + 8 * (2 * DK + DV))
                        record(summary, "gla_decode_lazy_conv", err_o, *timed[p], moved, flops, bf)
                k_rings, k_bufs = out[1:4], list(out[4:8])
                p_rings, p_bufs = ref[1:4], list(ref[4:8])
                c_state, c_rings = cls[1], cls[2:]
            ref_s = gla_cuda.gla_fold_plain(s0, *p_bufs)
            state = s0.clone()
            new_s = gla_cuda.gla_fold(state, *k_bufs)
            torch.cuda.synchronize()
            require(new_s.data_ptr() == state.data_ptr() and new_s.dtype == st,
                    "state not folded in place")
            print(f"gla_fold {tag}:")
            err_s = max_err(new_s, ref_s)
            check("state", err_s, bound(ref_s, tol_s))
            # the classic state was rounded to the state dtype at each step
            check("state vs 16 classic steps", max_err(new_s, c_state),
                  bound(c_state, TOL_LOGITS if st == bf else TOL_BF16))
            if st == bf:
                classic_ms = device_ms(lambda: gla_cuda.gla_decode_conv(
                    *toks[-1], *taps, *rings, states()), 50)
                print(f"  classic gla_decode_conv step at {tag}, for comparison: device ms "
                      f"{classic_ms:.6f}")
                ms, plain_ms = timed_pair(
                    f"gla_fold {tag}", lambda: gla_cuda.gla_fold(states(), *k_bufs),
                    lambda: gla_cuda.gla_fold_plain(states(), *k_bufs), 50)
                if b == BATCH:
                    record(summary, "gla_fold", err_s, ms, plain_ms,
                           nbytes(state, state, *k_bufs),
                           b * H * DK * (DV * (2 * WINDOW + 1) + 2 * WINDOW), bf)


def set_kernel_mode(model, mode):
    for layer in model.attentive_rnn.gla_layers():
        layer.kernel_mode = mode


def expect_launches(launches, **expected):
    """Every kernel's launch count of one main-path run: the named ones as
    given, the others 0."""
    want = {**dict.fromkeys(launches, 0), **expected}
    print(f"  expected {want}")
    require(launches == want, f"launches {launches}, expected {want}")


def add_launches(total, more):
    for name, n in more.items():
        total[name] += n


def generate_phase(torch, np, gla_cuda, card_line):
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
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_conv=N_GLA_LAYERS * steps)
    toks = res.tokens
    require(toks.shape == (cfg.n_quant, BATCH, MAX_SEQLEN), f"tokens {tuple(toks.shape)}")
    require(int(toks.min()) >= 0 and int(toks.max()) < model.n_target_vocab,
            "tokens out of range")
    cuts = cut_outputs(res, cfg.n_quant)
    print(f"tokens in range; cut lengths {[c[0].shape[-1] for c in cuts]}")

    # the same requests, greedy, through lazy windows of 16 steps and a fold
    gla_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    lazy = generate_batch(model, text, prompt=prompt, max_seqlen=MAX_SEQLEN, k=1,
                          force_max_seqlen=True, lazy_window=WINDOW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lazy_launches = gla_cuda.launch_counts()
    windows = -(-(MAX_SEQLEN - n_pre) // WINDOW)
    print(f"generate_batch(lazy_window={WINDOW}): {BATCH} requests, {lazy.n_steps} steps "
          f"({windows} windows decoded), {wall:.3f} s wall [{card_line}]")
    print(f"launches: {lazy_launches}")
    expect_launches(lazy_launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_lazy_conv=N_GLA_LAYERS * WINDOW * windows,
                    gla_fold=N_GLA_LAYERS * windows)
    require(lazy.tokens.shape == toks.shape, f"lazy tokens {tuple(lazy.tokens.shape)}")
    require(int(lazy.tokens.min()) >= 0 and int(lazy.tokens.max()) < model.n_target_vocab,
            "lazy tokens out of range")
    add_launches(launches, lazy_launches)

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
    return model, cfg, launches


def serve(torch, srv, requests):
    """Submit ``requests`` and drain the server one decode chunk at a time
    through its public API, ``run(max_chunks=1)``, on the host clock (a call
    ends in a host read of the chunk's tokens, and nothing is added to it).
    Returns (completions by rid, number of decode chunks, [(ms, active
    slots)] of the calls that ran a decode chunk and no prefill: every call
    but the first that completed no request, since a slot is refilled only
    in the call that frees it)."""
    rids = [srv.submit(text, prompt=prompt, max_len=max_len)
            for text, prompt, max_len in requests]
    done, chunk_ms, n_chunks = {}, [], 0
    torch.cuda.synchronize()
    while n_chunks == 0 or srv.active:
        active = srv.active
        t0 = time.perf_counter()
        out = srv.run(max_chunks=1)
        ms = (time.perf_counter() - t0) * 1e3
        if n_chunks and not out:
            chunk_ms.append((ms, active))
        n_chunks += 1
        done.update((c.rid, c) for c in out)
    require(set(done) == set(rids), f"completed {sorted(done)} of {rids}")
    return done, n_chunks, chunk_ms


def prefill_times(torch, model, requests, card_line, repeats=3):
    """Host ms of one request's prefill and insertion, through the public
    API: a request whose max_len is its forced length ends at its prefill,
    so ``run()`` prefills it (b1, power-of-two chunks), inserts it and
    returns without a decode chunk. Outside the counted main-path runs."""
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                       lazy=True, k=1)
    for text, prompt, _ in requests[:len(SERVE_PROMPTS)]:
        n_forced = 1 + (0 if prompt is None else prompt.shape[1])
        ms = []
        for _ in range(repeats):
            srv.submit(text, prompt=prompt, max_len=n_forced)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = srv.run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            require(len(done) == 1 and done[0].length == n_forced and srv.active == 0,
                    "the request did not end at its prefill")
        print(f"  prefill and insertion of a {n_forced - 1}-code prompt "
              f"({len(_pow2_chunks(n_forced))} chunks, b1): {ms} ms [{card_line}]")


def serving_phase(torch, np, gla_cuda, model, cfg, card_line):
    """DecodeServer at the flagship's full width and depth: 12 requests
    through 8 recycled slots in lazy mode, 8 in classic mode (every slot
    busy, so that both modes are timed at 8 slots)."""
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    rng = np.random.default_rng(1)
    requests = []
    for i in range(SERVE_REQUESTS):
        p_len = SERVE_PROMPTS[i % len(SERVE_PROMPTS)]
        prompt = rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, p_len)) if p_len else None
        requests.append((rng.integers(3, cfg.n_txt_vocab, size=TEXT_LEN), prompt,
                         240 + 40 * (i % 5)))
    total = dict.fromkeys(gla_cuda.launch_counts(), 0)
    tokens_by_mode = {}
    for lazy, reqs in ((True, requests), (False, requests[:SERVE_CLASSIC_REQUESTS])):
        mode = "lazy" if lazy else "classic"
        srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                           lazy=lazy, k=1)
        torch.cuda.synchronize()
        gla_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        done, n_chunks, chunk_ms = serve(torch, srv, reqs)
        wall = time.perf_counter() - t0
        launches = gla_cuda.launch_counts()
        n_tokens = sum(c.length for c in done.values())
        print(f"DecodeServer {mode}: {len(reqs)} requests through {SERVE_SLOTS} slots, "
              f"{n_chunks} decode chunks of {WINDOW}, {n_tokens} tokens, {wall:.3f} s wall "
              f"[{card_line}]")
        print(f"launches: {launches}")
        chunks = [_pow2_chunks(1 + (0 if p is None else p.shape[1])) for _, p, _ in reqs]
        later = sum(len(c) - 1 for c in chunks)
        step = {"gla_decode_lazy_conv": N_GLA_LAYERS * WINDOW * n_chunks,
                "gla_fold": N_GLA_LAYERS * n_chunks} if lazy else {
                    "gla_decode_conv": N_GLA_LAYERS * WINDOW * n_chunks}
        expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS * len(reqs),
                        gla_chunk=N_GLA_LAYERS * later, **step)
        add_launches(total, launches)
        for (text, prompt, max_len), c in zip(reqs, (done[r] for r in sorted(done))):
            require(c.tokens.shape == (c.length, cfg.n_quant) and c.length <= max_len
                    and (c.stopped or c.length == max_len), f"request {c.rid}: length {c.length}")
            require(int(c.tokens.min()) >= 0 and int(c.tokens.max()) < model.n_target_vocab,
                    f"request {c.rid}: tokens out of range")
        sizes = sorted(srv.prefill_chunk_sizes)
        require(all(c & (c - 1) == 0 for c in sizes), f"prefill chunk sizes {sizes}")
        require(sizes == sorted({c for cs in chunks for c in cs}), f"prefill chunk sizes {sizes}")
        # every shape the server gave a prefill kernel was held against its
        # plain version in the kernel phase
        require({cs[0] for cs in chunks} <= set(CONV_CHUNK_T)
                and {c for cs in chunks for c in cs[1:]} <= set(CHUNK_T),
                f"prefill chunks {chunks} not all covered by the kernel phase")
        if len(reqs) > SERVE_SLOTS:
            print(f"  {len(reqs) - SERVE_SLOTS} requests were served from recycled slots")
        full = [ms for ms, active in chunk_ms if active == SERVE_SLOTS]
        if full:
            mean = sum(full) / len(full)
            print(f"  {mode} decode chunk (no prefill in the call) at {SERVE_SLOTS} slots: "
                  f"mean {mean:.3f} ms, min "
                  f"{min(full):.3f}, max {max(full):.3f} over {len(full)} chunks -> "
                  f"{SERVE_SLOTS * WINDOW / mean * 1e3:.1f} tokens/s [{card_line}]")
        part = [ms for ms, active in chunk_ms if active < SERVE_SLOTS]
        if part:
            print(f"  {mode} decode chunk below {SERVE_SLOTS} active slots: mean "
                  f"{sum(part) / len(part):.3f} ms over {len(part)} chunks [{card_line}]")
        print(f"  prefill chunk sizes {sizes}")
        tokens_by_mode[mode] = done

    # lazy and classic serving of the same request, and generate_batch: the
    # same recurrence in other summation orders and batch sizes, so greedy
    # tokens may part ways in bf16 -- printed, not required
    text, prompt, max_len = requests[0]
    ref = generate_batch(model, torch.from_numpy(text)[None].to(DEVICE),
                         prompt=torch.from_numpy(prompt)[:, None].to(DEVICE),
                         max_seqlen=max_len, k=1, force_max_seqlen=True, lazy_window=WINDOW)
    ref_toks = ref.tokens[:, 0].T.cpu().numpy()
    for mode, done in tokens_by_mode.items():
        c = done[0]
        same = float((c.tokens == ref_toks[:c.length]).mean())
        print(f"greedy token agreement, {mode} server vs generate_batch(lazy_window={WINDOW}) "
              f"at b1, request 0: {same:.4f} of {c.length} steps")

    prefill_times(torch, model, requests, card_line)
    chunked_prefill_check(torch, model, cfg, requests[0])
    serving_paths_check(torch, np, gla_cuda, model, requests)
    return total


def chunked_prefill_check(torch, model, cfg, request):
    """A 150-code request's prefill as the server runs it (151 forced
    tokens as chunks of 128, 16, 4, 2 and 1, conv rings carried) against
    one-shot model.prefill: last logits and every state leaf. bf16 states
    are rounded at each chunk boundary, hence the logits tolerance."""
    from lina_speech_tpu_torch.serving import _pow2_chunks

    text, prompt, _ = request
    with torch.no_grad():
        x_enc = model.encode_text(torch.from_numpy(text)[None].to(DEVICE))
        codes = torch.cat([torch.ones(cfg.n_quant, 1, 1, dtype=torch.long),
                           torch.from_numpy(prompt)[:, None] + cfg.n_special_token_in], 2)
        forced = model.embed_tokens(codes.to(DEVICE))
        full, _, st_full = model.prefill(forced, x_enc, model.empty_state(1, DEVICE))
        st, off = model.empty_state(1, DEVICE), 0
        for c in _pow2_chunks(forced.shape[1]):
            part, _, st = model.prefill(forced[:, off:off + c], x_enc, st,
                                        conv_history=off > 0, time_offset=off)
            off += c
    torch.cuda.synchronize()
    print(f"prefill of {forced.shape[1]} tokens as chunks {_pow2_chunks(forced.shape[1])} "
          "vs one shot:")
    check("last logits", max_err(part[:, -1], full[:, -1]), bound(full[:, -1], TOL_LOGITS))
    print(f"  max|one-shot last logits| {float(full[:, -1].float().abs().max()):.3e}")
    check_states("state after the chunked prefill vs one shot", st, st_full, TOL_STATE,
                 live=("s", "conv_q", "conv_k", "conv_v"))


def serving_paths_check(torch, np, gla_cuda, model, requests):
    """The server's own device path, teacher-forced: 8 requests with mixed
    prompts are served in lazy mode on the kernel path while every logits
    tensor and every sampled token is recorded; the same requests are then
    served on the plain path (kernel_mode="chunk") with the recorded tokens
    forced, and the logits and the final slot states compared. The launch
    counts of the plain run must all be 0. Teacher forcing needs a hook the
    public API does not have: the check replaces the server's ``_sample`` and
    reads its ``_state``; it times nothing."""
    from lina_speech_tpu_torch.serving import DecodeServer

    reqs = [(text, prompt, (1 if prompt is None else 1 + prompt.shape[1]) + 2 * WINDOW)
            for text, prompt, _ in requests[:SERVE_SLOTS]]
    logits, tokens, states = {"auto": [], "chunk": []}, [], {}
    for mode in ("auto", "chunk"):
        set_kernel_mode(model, mode)
        srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                           lazy=True, k=1)
        replay = iter(tokens)

        def sample(lg, mode=mode, replay=replay):
            logits[mode].append(lg.float())
            if mode == "chunk":
                return next(replay)
            tokens.append(lg.argmax(-1))
            return tokens[-1]

        srv._sample = sample
        gla_cuda.reset_launch_counts()
        for text, prompt, max_len in reqs:
            srv.submit(text, prompt=prompt, max_len=max_len)
        done = srv.run()
        require(len(done) == len(reqs), f"{mode}: {len(done)} completions")
        states[mode] = srv._state
        if mode == "chunk":
            expect_launches(gla_cuda.launch_counts())
    set_kernel_mode(model, "auto")
    torch.cuda.synchronize()
    require(len(logits["auto"]) == len(logits["chunk"]), "sampling calls differ")
    worst, agree, n, largest = None, 0.0, 0, 0.0
    for a, c in zip(logits["auto"], logits["chunk"]):
        require(bool(torch.isfinite(a).all() and torch.isfinite(c).all()), "non-finite logits")
        err, tol = max_err(a, c), bound(c, TOL_LOGITS)
        largest = max(largest, float(c.abs().max()))
        if worst is None or err / tol > worst[0] / worst[1]:
            worst = (err, tol)
        agree += float((a.argmax(-1) == c.argmax(-1)).float().sum())
        n += a[..., 0].numel()
    print(f"server logits, kernel path vs plain path, teacher-forced "
          f"({len(logits['auto'])} sampling calls):")
    check("logits, worst call", *worst)
    print(f"  max|plain logits| {largest:.3e}, argmax agreement {agree / n:.4f}")
    # with random weights the mixers' outputs are small beside the residual
    # stream, so the logits say little; the servers' final states (folded
    # recurrent states, conv rings, window buffers) are the kernels' own
    # output, and each is held to its own magnitude
    check_states("final slot states, kernel path vs plain path", states["auto"],
                 states["chunk"], TOL_BF16,
                 live=("s", "conv_q", "conv_k", "conv_v", "kbuf", "vbuf", "cbuf"))


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
    chunk_kernel_phase(torch, gla_cuda, summary)
    lazy_kernel_phase(torch, gla_cuda, summary)
    model, cfg, launches = generate_phase(torch, np, gla_cuda, card_line)
    add_launches(launches, serving_phase(torch, np, gla_cuda, model, cfg, card_line))
    kernels = []
    for name, source, replaces in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **summary[name]))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
