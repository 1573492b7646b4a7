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
   forcing, every state tensor within a share of its own magnitude;
6. backward kernel phase: gla_chunk_conv as training calls it (autograd
   recording: the forward kernel, and the five CUDA kernels of the
   hand-written backward behind a torch.autograd.Function) against the plain
   version and autograd through it at the training shape b 8, t 512, 317 and
   128, bf16 IO, with an f32, a bf16 and no initial state, random do and
   dsf: o and the final state, and all eight gradient leaves, each within a
   share of its own max|plain|, finite and non-zero; forward and backward
   times beside their bounds and the plain version's;
7. training phase: the flagship at full depth and width (f32 parameters,
   bf16 compute, dropout 0.1 in the text encoder) takes five optimizer steps
   of make_train_step on synthetic batches of 8 (audio length 128-512), the
   last with grad_accum_steps=2; loss and grad_norm finite, launch counts per
   micro-batch 25 forward and 25 backward and nothing else, every parameter
   moved; on a batch of 2 the kernel path against the plain path: loss and
   every parameter's gradient (finite, each within a share of its own
   max|plain|); ms per step, frames per second, peak memory;
8. tuning phase: initial-state tuning on the flagship through
   train_initial_state (rank 1, batch 2, grad_acc 2, two optimizer updates):
   the model takes no gradient and does not move, each of the 48 S0 params
   has a finite non-zero gradient (the kernel's ds0), held against the plain
   path on one micro-step;
9. launched shapes phase: every (batch, length, initial state, wanted
   gradients) on which phases 7 and 8 launched the forward and backward
   kernels is held against the plain version as in phase 6, so no shape
   that trained went unchecked at the kernel's own level.
Between phases 5 and 6, on the flagship of phase 4, quantized serving:
5a. quantized kernel phase: int8_linear (both modes) at m 1, 8, 64 and 128
   for every (K, N) of the flagship's quantized layers, fused_ffn_int8 at m
   1, 8 and 64, the lazy step over an int8 state (b 8 and 64, p 0, 7, 15) and
   the requantizing fold gla_fold_q, each against its plain version (int8
   states by integers, at most one step apart, and by their scales); times
   on a rotation of cold weights and states beside the bounds and beside
   the bf16 library call the int8 stream has to beat;
5b. quantized generate phase: generate_batch(weight_quant="int8") with the
   classic loop at b 1 and b 8 and generate_batch(weight_quant="int8",
   lazy_window=16, state_quant="int8") at b 8, launch counts against a
   formula written from the model's structure; one lazy window
   teacher-forced through the kernel path and the plain path (finite logits
   at every step, every state leaf, the int8 states by integers); ms per
   token quantized beside unquantized, resident weight bytes, and a profile
   of 8 decode steps at b 1 with int8 weights;
5c. quantized serving phase: DecodeServer(lazy=True, state_quant="int8",
   weight_quant="int8") serves 12 requests through 8 recycled slots, then a
   server with int8_prefill_full_precision=False (the float weights leave
   the model) serves 4; every shape those runs gave int8_linear and
   fused_ffn_int8 is held against the plain version, or the phase fails.
After phase 9, the GLA layers without per-projection convs:
10. gla_chunk's backward and gla_decode against their plain versions;
   simple-GLA, Mamba-2, the interleaved and the PP backbones at the
   flagship's width through their paths; every shape launched held;
then RWKV6:
11. RWKV6 kernel phase: rwkv6_chunk, its hand-written backward and
   rwkv6_decode against their plain versions at h4 dk256 dv256 (bf16 IO,
   f32 w and u): the forward at b8 t151, b1 t128 and b1 t1 with an f32 and
   with no initial state, forward and backward at b8 t512 with and without
   one (dr, dk, dv, dw, du, ds0), the decode token at b1, b8 and b64 with
   f32 and bf16 states on cold states; every time beside its bound;
12. RWKV6 phase: kind="rwkv6" at the flagship's width (291,117,378
   parameters, random weights from seed 0 with u, the ddlerp mixes and the
   decays drawn off their constant inits; bf16 compute, f32 states):
   generate_batch for the 8 requests of phase 4 (classic loop), the kernel
   path held against the plain path under teacher forcing (logits, s and
   shift of every layer), a DecodeServer in classic mode (8 requests, 8
   slots) and three train steps at b8, the kernel path's loss and
   gradients held against the plain path's on a batch of 2; launch counts
   25 rwkv6_decode per token, 25 rwkv6_chunk and 25 rwkv6_chunk_bwd per
   micro-batch; then every shape those runs launched the three kernels on
   is held against the plain versions.
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
# Gradients of the hand-written backward vs autograd through the plain
# version, relative to each leaf's own max|plain| (no floor): both compute in
# f32 and round dx to bf16 (one ulp is 4e-3 of a value), and a bf16
# pre-activation that rounds the other way moves silu' by an ulp.
TOL_GRAD = 2e-2
# Parameter gradients of the whole flagship, kernel path vs plain path
# (bf16 compute through 25 layers): the o of every layer differs by bf16 ulps
# between the paths, and the difference rides through the bf16 GEMMs (an
# H100 reads 1.4e-2 at worst). Leaves whose gradient is zero in exact
# arithmetic are left out (zero_gradient_mask).
TOL_PARAM_GRAD = 3e-2
TRAIN_T = (512, 317, 128)
# (b, t, initial-state dtype or None, need_ds0, need_taps) at which the
# training forward and its backward were held against their plain versions,
# and what the training and tuning phases launched them on
HELD, LAUNCHED = set(), set()
TRAIN_BATCH, TRAIN_STEPS, MIN_AUDIO, MAX_AUDIO = 8, 5, 128, 512
DEVICE = "cuda"
# published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32, PEAK_INT8 = 3.35e12, 989e12, 67e12, 1979e12
D_MODEL, FFN_HIDDEN, N_TEXT_LAYERS = 1024, 1365, 4
# int8 products per decode step: q, k, v, g, o of each GLA layer and q, k, v of
# the cross-attention (the 16-wide gate projections stay float); one fused FFN
# per block. A full forward (an int8 prefill chunk) launches the same.
INT8_LINEARS_PER_STEP = 5 * N_GLA_LAYERS + 3
# (K, N) of the flagship's quantized layers that reach int8_linear, and the
# FFN's two (ragged: 1365 and 2730 are no multiples of 16), which reach it
# under w8a8 and in the unfused route
QLINEAR_KN = ((1024, 1024), (1024, 2048), (2048, 1024), (1024, 2 * FFN_HIDDEN),
              (FFN_HIDDEN, 1024))
QLINEAR_M = (1, 8, 64, 128)
FFN_M = (1, 8, 64)
# shapes at which int8_linear and fused_ffn_int8 were held against their plain
# versions (ops/qlinear.py:launch_shapes keys)
Q_HELD = {"int8_linear": set(), "fused_ffn_int8": set()}
# ... and the shapes the driven paths launched them on (read_counts notes them)
Q_LAUNCHED = {"int8_linear": set(), "fused_ffn_int8": set()}
# the int8 product's outputs are bf16: one bf16 step of the leaf's own size
TOL_Q = 2.0 ** -7
# State leaves, kernel path vs plain path, ON INT8 WEIGHTS: the two paths then
# differ at every Linear's output (an f32 sum in another order, rounded to
# bf16), not only at the GLA kernels', and the bf16 steps add up through the
# 25 layers (an H100 reads 1.9e-2 of a leaf's max at worst, two bf16 steps of
# its largest values)
TOL_QPATH = 4e-2
KERNELS = (  # name, source, the TPU kernel it replaces
    ("gla_chunk_conv", "lina_speech_tpu_torch/csrc/gla_chunk_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1289"),
    ("gla_chunk_conv_bwd", "lina_speech_tpu_torch/csrc/gla_chunk_conv_bwd.cu",
     "lina_speech_tpu/ops/gla_pallas.py:861"),
    ("gla_chunk", "lina_speech_tpu_torch/csrc/gla_chunk.cu",
     "lina_speech_tpu/ops/gla_pallas.py:699"),
    ("gla_chunk_bwd", "lina_speech_tpu_torch/csrc/gla_chunk_bwd.cu",
     "lina_speech_tpu/ops/gla_pallas.py:210"),
    ("gla_decode_conv", "lina_speech_tpu_torch/csrc/gla_decode_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1641"),
    ("gla_decode", "lina_speech_tpu_torch/csrc/gla_decode.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1709"),
    ("gla_decode_lazy_conv", "lina_speech_tpu_torch/csrc/gla_decode_lazy_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2197"),
    ("gla_fold", "lina_speech_tpu_torch/csrc/gla_fold.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2232"),
    ("gla_decode_lazy_conv_int8", "lina_speech_tpu_torch/csrc/gla_decode_lazy_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2197 (int8 state, body :1802)"),
    ("gla_fold_q", "lina_speech_tpu_torch/csrc/gla_fold_q.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2097"),
    ("int8_linear", "lina_speech_tpu_torch/csrc/int8_linear.cu",
     "lina_speech_tpu/ops/qlinear.py:127"),
    ("fused_ffn_int8", "lina_speech_tpu_torch/csrc/fused_ffn_int8.cu",
     "lina_speech_tpu/ops/qlinear.py:241"),
    ("rwkv6_chunk", "lina_speech_tpu_torch/csrc/rwkv6_chunk.cu",
     "lina_speech_tpu/ops/rwkv6_pallas.py:565"),
    ("rwkv6_chunk_bwd", "lina_speech_tpu_torch/csrc/rwkv6_chunk_bwd.cu",
     "lina_speech_tpu/ops/rwkv6_pallas.py:137"),
    ("rwkv6_decode", "lina_speech_tpu_torch/csrc/rwkv6_decode.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1728"))
# times at further shapes than a kernel's row of the summary, each with its
# bound: {kernel name: [{shape, ms, plain_ms, bound_ms, bound_by}, ...]}
OTHER_SHAPES = {}
# The GLA-family variants at the flagship's width (d 1024, 12 + 12 layers and
# the blind pos_net): simple-GLA without convs (4 heads, dk 256, dv 256, bf16
# IO) and Mamba-2 (32 heads, d_state 64 as dk, headdim 64 as dv, f32 IO);
# both keep f32 states, as the JAX package builds them
SIMPLE_HEAD = (4, 256, 256)
MAMBA_HEAD = (32, 64, 64)
VARIANT_TRAIN_STEPS = {"simple_gla": 5, "mamba2": 3}
INTERLEAVED_LAYERS, SHORT_STEPS, SHORT_BATCH = (5, 11), 16, 2
# (b, h, t, dk, dv, IO dtype, initial-state dtype or None, scale) at which
# gla_chunk was held against its plain version; with need_ds0 appended, the
# same for its backward; (b, h, dk, dv, IO dtype, state dtype) for
# gla_decode. GLA_LAUNCHED gathers what the driven paths launched them on
# (ops/gla_cuda.py:launch_shapes), and the last phase holds the rest.
CHUNK_HELD, CHUNK_BWD_HELD, DECODE_HELD = set(), set(), set()
GLA_LAUNCHED = {"gla_chunk": set(), "gla_chunk_bwd": set(), "gla_decode": set()}
# RWKV6 at the flagship's width (kind="rwkv6": d 1024, 12 + 12 layers and the
# blind pos_net, 4 heads of dk 256 and dv 256, bf16 IO, f32 w and u, f32
# states), with the parameters that initialize to constants (the bonus u, the
# ddlerp mixes, the decays) drawn from seed 0 (models/rwkv6.py:perturb_rwkv6_params_)
RWKV6_HEAD = (4, 256, 256)
N_RWKV6_PARAMS = 291_117_378
VARIANT_TRAIN_STEPS["rwkv6"] = 3
# RWKV6's teacher-forced logits and state leaves in bf16, kernel path vs plain
# path: the plain chunked form rounds its matmul operands to bf16 (the
# intra-chunk scores, the state at every chunk boundary: the JAX package's
# rounding points) where the kernels keep f32, so o parts by ~0.4% in every
# layer and the ddlerp and the per-head norm carry it through 25 layers (an
# H100 read 6.2e-2 of the logits' max). Held loosely here, as a net for a
# wrong state or a wrong token; the same comparison on the model built in f32
# compute holds the path to TOL_F32, and layer 0's state to TOL_BF16 in bf16.
TOL_RWKV6_PATH = 2.5e-1
# what the RWKV6 kernels were held against their plain versions at, and what
# the driven paths launched them on (ops/rwkv6_cuda.py:launch_shapes keys)
RWKV6_HELD = {"rwkv6_chunk": set(), "rwkv6_chunk_bwd": set(), "rwkv6_decode": set()}
RWKV6_LAUNCHED = {"rwkv6_chunk": set(), "rwkv6_chunk_bwd": set(), "rwkv6_decode": set()}


def reset_counts():
    from lina_speech_tpu_torch.ops import gla_cuda, qlinear, rwkv6_cuda

    gla_cuda.reset_launch_counts()
    qlinear.reset_launch_counts()
    rwkv6_cuda.reset_launch_counts()


def read_counts() -> dict:
    """Every wrapper's launch count; the lazy step's launches on an int8
    state are counted a second time under a name of their own. Also notes,
    in Q_LAUNCHED, GLA_LAUNCHED and RWKV6_LAUNCHED, the shapes the int8
    products, gla_chunk, its backward, gla_decode and the three RWKV6
    kernels were launched on since the last reset."""
    from lina_speech_tpu_torch.ops import gla_cuda, qlinear, rwkv6_cuda

    for name, shapes in qlinear.launch_shapes().items():
        Q_LAUNCHED[name] |= shapes
    for name, shapes in gla_cuda.launch_shapes().items():
        if name in GLA_LAUNCHED:
            GLA_LAUNCHED[name] |= shapes
    for name, shapes in rwkv6_cuda.launch_shapes().items():
        RWKV6_LAUNCHED[name] |= shapes
    return {**gla_cuda.launch_counts(), **qlinear.launch_counts(),
            **rwkv6_cuda.launch_counts(),
            "gla_decode_lazy_conv_int8": gla_cuda.gla_decode_lazy_conv.q_launches}


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


def cold_rotation(*tensors):
    """A callable that hands out copies of a group of tensors used together
    (a state and its scales, an int8 weight) in turn, twice the 50 MB L2
    cache in all: the model cycles through 25 layers' states and weights, so
    a decode kernel finds them in device memory, not in the cache. Timing
    one copy over and over would measure the cache."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-100_000_000 // size))
    pool = itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(n)])
    return lambda: next(pool)


def cold_pool(state):
    """:func:`cold_rotation` of one tensor, handed out bare."""
    rotation = cold_rotation(state)
    return lambda: rotation()[0]


def ptxas_summary(log: str):
    """ptxas register / spill lines of the instantiations the main path
    launches (bf16 IO, bf16 state, head key dim 256)."""
    labels = ((("bwd_dq_kernel", "Lb1E"), "gla_chunk_conv_bwd dq sweep"),
              (("bwd_dkv_kernel", "Lb1E"), "gla_chunk_conv_bwd dk/dv sweep"),
              (("bwd_dq_kernel", "Lb0E"), "gla_chunk_bwd dq sweep"),
              (("bwd_dkv_kernel", "Lb0E"), "gla_chunk_bwd dk/dv sweep"),
              (("gla_decode_lazy_conv_kernel",), "gla_decode_lazy_conv"),
              (("gla_decode_kernel", "Lb1E"), "gla_decode_conv"),
              (("gla_decode_kernel", "Lb0E"), "gla_decode"),
              (("gla_fold_kernel",), "gla_fold"), (("gla_chunk_kernel", "Lb1E"), "gla_chunk_conv"),
              (("gla_chunk_kernel", "Lb0E"), "gla_chunk"))
    # the quantized kernels' bf16 instantiations (m-tile 1 and 8; dv 512)
    quant = (("int8_linear_wonly_kernelI13__nv_bfloat16S", "int8_linear wonly<bf16, bf16>"),
             ("int8_linear_w8a8_kernelI13__nv_bfloat16L", "int8_linear w8a8<bf16>"),
             ("ffn_chunk_kernelI13__nv_bfloat16L", "fused_ffn_int8 chunk<bf16>"),
             ("gla_fold_q_kernelI13__nv_bfloat16Li16E", "gla_fold_q<bf16, dv 512>"),
             ("gla_decode_lazy_conv_kernelI13__nv_bfloat16aLi256E",
              "gla_decode_lazy_conv<bf16, int8, 256>"))
    # the RWKV6 kernels' bf16-IO, f32-state instantiations (dk 256)
    rwkv6 = (("rwkv6_chunk_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk"),
             ("rwkv6_bwd_dr_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk_bwd dr sweep"),
             ("rwkv6_bwd_dkv_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk_bwd dk/dv sweep"),
             ("rwkv6_decode_kernelI13__nv_bfloat16fLi256E", "rwkv6_decode"))
    name, out = "", []
    for line in log.splitlines():
        if "entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.split("for")[-1].strip()
            continue
        if not ("registers" in line or "spill" in line):
            continue
        info = line.split(":", 1)[-1].strip()
        if re.search(r"I13__nv_bfloat16S\d*_Li256E", name) and "rwkv6" not in name:
            kernel = next((label for keys, label in labels
                           if all(key in name for key in keys)), name)
            out.append(f"{kernel}<bf16, bf16, 256>: {info}")
        for key, label in quant:
            if key in name and re.search(r"Li(1|8|16|256)E", name):
                tile = re.search(r"Li(\d+)E", name).group(1)
                out.append(f"{label} (tile {tile}): {info}")
        out += [f"{label}<bf16, f32, 256>: {info}" for key, label in rwkv6 if key in name]
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes, flops, io_dtype):
    """(bound_ms, bound_by): the least time one H100 could take -- the
    bytes of every input read once and every output written once over the
    card's memory rate, or the function's operations over the card's peak
    rate for the inputs' type (bf16 and int8: tensor cores; f32: outside
    them), whichever is larger."""
    import torch

    t_bytes = n_bytes / PEAK_BYTES
    peak = {torch.bfloat16: PEAK_BF16, torch.int8: PEAK_INT8}.get(io_dtype, PEAK_F32)
    t_ops = flops / peak
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
    import torch

    worst, failed, ints = {}, [], None
    got_sc, ref_sc = ({place: t for field, place, t in state_leaves(st) if field == "s_scale"}
                      for st in (got, ref))
    for (field, place, a), (_, _, r) in zip(state_leaves(got), state_leaves(ref)):
        require(a.shape == r.shape and a.dtype == r.dtype, f"{name}: {place} {field} differs "
                f"in shape or dtype: {tuple(a.shape)} {a.dtype} vs {tuple(r.shape)} {r.dtype}")
        if a.dtype == torch.int8:
            # an int8 state of one model run against another's: by integers,
            # and dequantized with its row scales like a float state. The two
            # runs fold in windows that differ by bf16 steps, so a value near
            # a rounding boundary lands one step apart; a row of small keys,
            # whose relative difference is larger, or a row whose scale moved,
            # lands further (an H100 reads 7 steps in 1.4e-3 of a leaf)
            steps = (a.int() - r.int()).abs()
            top, off = int(steps.max()), float((steps > 0).float().mean())
            far = float((steps > 1).float().mean())
            if not bool(r.any()):
                failed.append(f"{place} {field}: reference is all zeros")
            if far > 1e-2 or off > 0.5:
                failed.append(f"{place} {field}: int8 steps apart: max {top}, share off "
                              f"{off}, share more than one step off {far}")
            if ints is None or (top, off) > ints[:2]:
                ints = (top, off, far, place)
            field = "s dequantized"
            a, r = (q.float() * sc[place][..., None] for q, sc in ((a, got_sc), (r, ref_sc)))
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
    if ints is not None:
        print(f"  int8 s ({ints[3]}), the leaf furthest apart: at most {ints[0]} integer steps, "
              f"{ints[1]:.4f} of its elements differ, {ints[2]:.6f} by more than one step")
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
        wv=(r(H * DV, 4) * 0.5).to(bf),
        s0=None if state_dtype is None else r(b, H, DK, DV).to(state_dtype),
        rings=[r(4, b, H, d).to(bf) for d in (DK, DK, DV)])


def record(summary, name, err, ms, plain_ms, n_bytes, flops, io_dtype, library_ms=None):
    """The kernel's row of the summary. ``library_ms`` stays None where no
    single PyTorch call computes the function (every GLA kernel)."""
    bound_ms, bound_by = roofline(n_bytes, flops, io_dtype)
    print(f"  {name} bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} bytes, {flops} operations); kernel {ms:.6f} ms")
    summary[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)


def note_shape(name, shape, ms, plain_ms, n_bytes, flops, io_dtype, library_ms=None):
    """A time at a further shape, with its bound; goes into the kernel's
    ``shapes`` list of the summary line."""
    bound_ms, bound_by = roofline(n_bytes, flops, io_dtype)
    print(f"  {name} {shape}: kernel {ms:.6f} ms, plain {plain_ms if plain_ms is None else round(plain_ms, 6)} "
          f"ms, bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes)"
          + (f", library {library_ms:.6f} ms" if library_ms is not None else ""))
    OTHER_SHAPES.setdefault(name, []).append(dict(
        shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms))


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
            moved = nbytes(*chunk_args, x["s0"], o_k, s_k)
            if b == BATCH and st == torch.bfloat16:
                record(summary, "gla_chunk_conv", err_o, ms, plain_ms, moved,
                       scan_flops(b, t, True), bf)
            else:
                note_shape("gla_chunk_conv", f"{tag} t{t}", ms, plain_ms, moved,
                           scan_flops(b, t, True), bf)

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
            # state read and written; every other input and output once
            moved = nbytes(*dec, state, *out_k)
            if b == BATCH and st == torch.bfloat16:
                record(summary, "gla_decode_conv", err_o, ms, plain_ms, moved,
                       scan_flops(b, 1, True), bf)
            else:
                note_shape("gla_decode_conv", tag, ms, plain_ms, moved, scan_flops(b, 1, True), bf)

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
                ms, plain_ms = timed_pair(
                    f"gla_chunk_conv b1 t{t}",
                    lambda: gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"]),
                    lambda: gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"]),
                    10)
                note_shape("gla_chunk_conv", f"b1 state bfloat16 t{t}", ms, plain_ms,
                           nbytes(*chunk_args, x["s0"], o_k, s_k), scan_flops(1, t, True), bf)
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
                CHUNK_HELD.add((b, H, t, DK, DV, bf, st, DK ** -0.5))
                if b == 1 and st == bf and t in (128, 1):
                    ms, plain_ms = timed_pair(
                        f"gla_chunk t{t}",
                        lambda: gla_cuda.gla_chunk(*args, initial_state=x["s0"]),
                        lambda: gla_cuda.gla_chunk_plain(*args, initial_state=x["s0"]), 10)
                    moved = nbytes(*args, x["s0"], o_k, s_k)
                    if t == 128:
                        record(summary, "gla_chunk", err_o, ms, plain_ms, moved,
                               scan_flops(b, t, False), bf)
                    else:
                        note_shape("gla_chunk", f"b1 state bfloat16 t{t}", ms, plain_ms, moved,
                                   scan_flops(b, t, False), bf)


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


def lazy_step_work(tok, taps, rings, state, s_scale, bufs, out, p):
    """(bytes, operations) of one lazy step at window position p: the live
    slots j < p are read, slot p is written, the state (and the row scales
    of an int8 one) read once."""
    b = tok[0].shape[0]
    moved = nbytes(*tok, *taps, *rings, state, s_scale, bufs[3], out[0], *out[1:4],
                   out[7]) + nbytes(*(t[:p + 1] for t in bufs[:3]))
    flops = b * H * (2 * DK * DV + (p + 1) * (3 * DK + 2 * DV) + 8 * (2 * DK + DV))
    return moved, flops


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
                    if p in timed:
                        moved, flops = lazy_step_work(tok, taps, k_rings, s0, None, k_bufs, out, p)
                        if b == BATCH and p == WINDOW - 1:
                            record(summary, "gla_decode_lazy_conv", err_o, *timed[p], moved,
                                   flops, bf)
                        else:
                            note_shape("gla_decode_lazy_conv", f"{tag} p{p}", *timed[p], moved,
                                       flops, bf)
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
                if b != BATCH:  # b8 is the summary's row (kernel_phase)
                    cls_out = gla_cuda.gla_decode_conv_plain(*toks[-1], *taps, *rings, s0)
                    note_shape("gla_decode_conv", tag, classic_ms, None,
                               nbytes(*toks[-1], *taps, *rings, s0, *cls_out),
                               scan_flops(b, 1, True), bf)
                ms, plain_ms = timed_pair(
                    f"gla_fold {tag}", lambda: gla_cuda.gla_fold(states(), *k_bufs),
                    lambda: gla_cuda.gla_fold_plain(states(), *k_bufs), 50)
                fold_work = (nbytes(state, state, *k_bufs),
                             b * H * DK * (DV * (2 * WINDOW + 1) + 2 * WINDOW))
                if b == BATCH:
                    record(summary, "gla_fold", err_s, ms, plain_ms, *fold_work, bf)
                else:
                    note_shape("gla_fold", tag, ms, plain_ms, *fold_work, bf)


def set_kernel_mode(model, mode):
    """"auto": the kernels; "chunk": the plain versions, for every GLA layer
    and every quantized Linear / SwiGLU."""
    model.set_kernel_mode(mode)


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
    reset_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, gen, prompt=prompt, max_seqlen=MAX_SEQLEN, k=TOPK,
                         force_max_seqlen=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
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
    reset_counts()
    t0 = time.perf_counter()
    lazy = generate_batch(model, text, prompt=prompt, max_seqlen=MAX_SEQLEN, k=1,
                          force_max_seqlen=True, lazy_window=WINDOW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lazy_launches = read_counts()
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

    # teacher-forced prefill + TF_STEPS decode steps, kernel path vs plain, on
    # the copies of the parameters in the compute dtype that generate_batch
    # decodes with (the model keeps its f32 parameters)
    with model.using_params(model.cast_param_copies()):
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


def serving_requests(np, cfg):
    """The serving phases' requests: (text ids, prompt codes or None, max_len),
    prompts of 150, 97, 33 and 0 codes in turn."""
    rng = np.random.default_rng(1)
    requests = []
    for i in range(SERVE_REQUESTS):
        p_len = SERVE_PROMPTS[i % len(SERVE_PROMPTS)]
        prompt = rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, p_len)) if p_len else None
        requests.append((rng.integers(3, cfg.n_txt_vocab, size=TEXT_LEN), prompt,
                         240 + 40 * (i % 5)))
    return requests


def check_served(model, cfg, srv, reqs, done, chunks):
    """Completions in range and of the asked length; the prefill chunk sizes
    are the binary decompositions ``chunks``, each a shape the kernel phase
    held the prefill kernels at."""
    for (text, prompt, max_len), c in zip(reqs, (done[r] for r in sorted(done))):
        require(c.tokens.shape == (c.length, cfg.n_quant) and c.length <= max_len
                and (c.stopped or c.length == max_len), f"request {c.rid}: length {c.length}")
        require(int(c.tokens.min()) >= 0 and int(c.tokens.max()) < model.n_target_vocab,
                f"request {c.rid}: tokens out of range")
    sizes = sorted(srv.prefill_chunk_sizes)
    require(all(c & (c - 1) == 0 for c in sizes), f"prefill chunk sizes {sizes}")
    require(sizes == sorted({c for cs in chunks for c in cs}), f"prefill chunk sizes {sizes}")
    require({cs[0] for cs in chunks} <= set(CONV_CHUNK_T)
            and {c for cs in chunks for c in cs[1:]} <= set(CHUNK_T),
            f"prefill chunks {chunks} not all covered by the kernel phase")
    print(f"  prefill chunk sizes {sizes}")


def report_chunk_times(mode, n_requests, chunk_ms, card_line):
    if n_requests > SERVE_SLOTS:
        print(f"  {n_requests - SERVE_SLOTS} requests were served from recycled slots")
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


def serving_phase(torch, np, gla_cuda, model, cfg, card_line):
    """DecodeServer at the flagship's full width and depth: 12 requests
    through 8 recycled slots in lazy mode, 8 in classic mode (every slot
    busy, so that both modes are timed at 8 slots)."""
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    requests = serving_requests(np, cfg)
    total = dict.fromkeys(read_counts(), 0)
    tokens_by_mode = {}
    for lazy, reqs in ((True, requests), (False, requests[:SERVE_CLASSIC_REQUESTS])):
        mode = "lazy" if lazy else "classic"
        srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                           lazy=lazy, k=1)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        done, n_chunks, chunk_ms = serve(torch, srv, reqs)
        wall = time.perf_counter() - t0
        launches = read_counts()
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
        check_served(model, cfg, srv, reqs, done, chunks)
        report_chunk_times(mode, len(reqs), chunk_ms, card_line)
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
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
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
        reset_counts()
        for text, prompt, max_len in reqs:
            srv.submit(text, prompt=prompt, max_len=max_len)
        done = srv.run()
        require(len(done) == len(reqs), f"{mode}: {len(done)} completions")
        states[mode] = srv._state
        if mode == "chunk":
            expect_launches(read_counts())
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


# ------------------------------------------------------- quantized serving
def quantized_weight(torch, n, k, seed):
    """A random (n, k) bf16 weight quantized as the model's are: (packed int8
    (n, kp), scales (n,), int8 (n, k), the weight dequantized to bf16)."""
    from lina_speech_tpu_torch.ops import qlinear
    from lina_speech_tpu_torch.utils.quantize import QKEY, SKEY, quantize_leaf

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    w = (torch.randn(n, k, generator=g, device=DEVICE) * k ** -0.5).to(torch.bfloat16)
    pair = quantize_leaf(w)
    deq = (pair[QKEY].float() * pair[SKEY]).to(torch.bfloat16)
    return (qlinear.pack_int8_weight(pair[QKEY]), pair[SKEY].reshape(-1).contiguous(),
            pair[QKEY], deq)


def hold_leaf(name, out, ref, rel):
    """``out`` within ``rel`` of its plain version's own max|ref| (no floor;
    a NaN or an all-zero reference fails); returns the error."""
    err, ref_max = max_err(out, ref), float(ref.float().abs().max())
    require(ref_max > 0, f"{name}: the plain version is all zeros")
    check(name, err, rel * ref_max)
    return err


def hold_int8_linear(torch, shape, summary=None, timed=False):
    """int8_linear against its plain version at one launch shape (m, K, N,
    mode, x dtype, out dtype); with ``timed`` its time on a rotation of cold
    weights beside the plain version's, the bound, and the library call the
    int8 stream has to beat: F.linear on the weight dequantized to bf16
    beforehand, which reads twice the bytes."""
    from lina_speech_tpu_torch.ops import qlinear

    m, k, n, mode, xdt, odt = shape
    q, s, _, deq = quantized_weight(torch, n, k, seed=k + n)
    g = torch.Generator(device=DEVICE).manual_seed(m)
    x = torch.randn(m, k, generator=g, device=DEVICE).to(xdt)
    out = qlinear.int8_linear(x, q, s, out_dtype=odt, mode=mode)
    ref = qlinear.int8_linear_plain(x, q, s, out_dtype=odt, mode=mode)
    torch.cuda.synchronize()
    require(out.shape == (m, n) and out.dtype == odt, "int8_linear output shape or dtype")
    tag = (f"{mode} m{m} K{k} N{n} {str(xdt).split('.')[-1]}->{str(odt).split('.')[-1]}")
    err = hold_leaf(f"int8_linear {tag}", out, ref, TOL_Q if odt == torch.bfloat16 else 1e-4)
    Q_HELD["int8_linear"].add(shape)
    if not timed:
        return
    weights, dense = cold_rotation(q), cold_rotation(deq)
    ms, plain_ms = timed_pair(
        f"int8_linear {tag}",
        lambda: qlinear.int8_linear(x, *weights(), s, out_dtype=odt, mode=mode),
        lambda: qlinear.int8_linear_plain(x, *weights(), s, out_dtype=odt, mode=mode), 50)
    xb = x.to(torch.bfloat16)
    library_ms = device_ms(lambda: torch.nn.functional.linear(xb, *dense()), 50)
    work = (nbytes(x, q, s, out), 2 * m * k * n,
            torch.int8 if mode == "w8a8" else torch.bfloat16)
    if summary is not None:
        record(summary, "int8_linear", err, ms, plain_ms, *work, library_ms=library_ms)
        print(f"  library (F.linear on the bf16 weight, {nbytes(deq)} weight bytes): "
              f"{library_ms:.6f} ms")
    else:
        note_shape("int8_linear", tag, ms, plain_ms, *work, library_ms=library_ms)


def hold_fused_ffn(torch, shape, summary=None, timed=False):
    """fused_ffn_int8 against its plain version at one launch shape (m, d,
    hidden, x dtype, out dtype), run twice (the fixed-order reduction gives
    the same bits); with ``timed`` its times, the bound and the library's:
    the two F.linear calls on bf16 weights and the activation between."""
    from lina_speech_tpu_torch.ops import qlinear

    F = torch.nn.functional
    m, d, hidden, xdt, odt = shape
    q_in, s_in, _, w_in = quantized_weight(torch, 2 * hidden, d, seed=d + 1)
    _, s_out, q_out, w_out = quantized_weight(torch, d, hidden, seed=d + 2)
    q_out_t = q_out.T.contiguous()
    g = torch.Generator(device=DEVICE).manual_seed(m)
    x = torch.randn(m, d, generator=g, device=DEVICE).to(xdt)
    b_in = (torch.randn(2 * hidden, generator=g, device=DEVICE) * 0.02).to(torch.bfloat16)
    b_out = (torch.randn(d, generator=g, device=DEVICE) * 0.02).to(torch.bfloat16)
    call = lambda fn, qi, qo: fn(x, qi, s_in, b_in, qo, s_out, b_out, out_dtype=odt)
    out = call(qlinear.fused_ffn_int8, q_in, q_out_t)
    again = call(qlinear.fused_ffn_int8, q_in, q_out_t)
    ref = call(qlinear.fused_ffn_int8_plain, q_in, q_out_t)
    torch.cuda.synchronize()
    require(out.shape == (m, d) and out.dtype == odt, "fused_ffn_int8 output shape or dtype")
    require(torch.equal(out, again), "fused_ffn_int8 differs from run to run")
    tag = f"m{m} d{d} hidden{hidden} {str(xdt).split('.')[-1]}->{str(odt).split('.')[-1]}"
    err = hold_leaf(f"fused_ffn_int8 {tag}", out, ref, TOL_Q)
    Q_HELD["fused_ffn_int8"].add(shape)
    if not timed:
        return
    weights, dense = cold_rotation(q_in, q_out_t), cold_rotation(w_in, w_out)
    ms, plain_ms = timed_pair(
        f"fused_ffn_int8 {tag}", lambda: call(qlinear.fused_ffn_int8, *weights()),
        lambda: call(qlinear.fused_ffn_int8_plain, *weights()), 50)
    xb = x.to(torch.bfloat16)

    def library():
        wi, wo = dense()
        gate, h = F.linear(xb, wi, b_in).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * h, wo, b_out)

    library_ms = device_ms(library, 50)
    work = (nbytes(x, q_in, s_in, b_in, q_out_t, s_out, b_out, out), 6 * m * d * hidden,
            torch.bfloat16)
    if summary is not None:
        record(summary, "fused_ffn_int8", err, ms, plain_ms, *work, library_ms=library_ms)
        print(f"  library (two F.linear on bf16 weights and the activation): "
              f"{library_ms:.6f} ms")
    else:
        note_shape("fused_ffn_int8", tag, ms, plain_ms, *work, library_ms=library_ms)


def quant_linear_kernel_phase(torch, summary):
    """int8_linear at m 1, 8, 64 and 128 for every (K, N) of QLINEAR_KN in
    both modes, fused_ffn_int8 at m 1, 8 and 64, bf16 in and out as the
    flagship runs them; timed at m 1, 8 and 64 (w8a8 at one (K, N)). The
    summary's rows: the b1 decode shapes, m 1."""
    bf = torch.bfloat16
    for k, n in QLINEAR_KN:
        for mode in ("wonly", "w8a8"):
            for m in QLINEAR_M:
                timed = m != 128 and (mode == "wonly" or (k, n) == (1024, 2048))
                main = (m, k, n, mode) == (1, 1024, 2048, "wonly")
                hold_int8_linear(torch, (m, k, n, mode, bf, bf), summary if main else None, timed)
    # f32 activations reach the kernel too (an f32 compute dtype)
    hold_int8_linear(torch, (3, FFN_HIDDEN, 1024, "wonly", torch.float32, torch.float32))
    hold_int8_linear(torch, (3, FFN_HIDDEN, 1024, "w8a8", torch.float32, bf))
    for m in FFN_M:
        hold_fused_ffn(torch, (m, D_MODEL, FFN_HIDDEN, bf, bf), summary if m == 1 else None, True)
    hold_fused_ffn(torch, (5, D_MODEL, FFN_HIDDEN, torch.float32, torch.float32))


def quant_lazy_kernel_phase(torch, gla_cuda, summary):
    """A whole lazy window over an int8 base state at b8 and b64: every step
    of gla_decode_lazy_conv with ``s_scale`` against its plain version, timed
    at p 0, 7 and 15 on a rotation of cold states, then gla_fold_q against
    its plain version: the new int8 state by integers (at most one step
    apart, and how many differ), the new scales, and the dequantized product;
    updated in place."""
    from lina_speech_tpu_torch.ops.gla import dequantize_state_rows, quantize_state_rows

    bf = torch.bfloat16
    for b in (8, 64):
        tag = f"b{b} state int8"
        toks, taps, rings, s_float, bufs = lazy_inputs(torch, b, torch.float32, seed=b + 1)
        state_q, s_scale = quantize_state_rows(s_float * 0.05)
        require(bool(state_q.any()) and float(s_scale.min()) > 0, "an empty int8 state")
        k_rings = p_rings = rings
        k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
        timed, states = {}, cold_rotation(state_q, s_scale)

        def step(fn, rings_, bufs_, p):
            q, sc = states()
            return fn(*tok, *taps, *rings_, q, *bufs_, p, s_scale=sc)

        for p, tok in enumerate(toks):
            ptrs = [t.data_ptr() for t in k_bufs[:3]]
            if p in (0, 7, 15):  # time the step before taking it
                scratch = [t.clone() for t in k_bufs]
                timed[p] = timed_pair(
                    f"gla_decode_lazy_conv {tag} p{p}",
                    lambda: step(gla_cuda.gla_decode_lazy_conv, k_rings, scratch, p),
                    lambda: step(gla_cuda.gla_decode_lazy_conv_plain, k_rings, scratch, p), 50)
            out = gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, state_q, *k_bufs, p,
                                                s_scale=s_scale)
            ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, state_q, *p_bufs, p,
                                                      s_scale=s_scale)
            torch.cuda.synchronize()
            require([t.data_ptr() for t in out[4:7]] == ptrs, "window buffers not written in place")
            if p in (0, 7, 15):
                print(f"gla_decode_lazy_conv {tag} p{p}:")
                err_o = hold_leaf("o", out[0], ref[0], TOL_BF16)
                for name, a, r_ in zip(("ring q", "ring k", "ring v"), out[1:4], ref[1:4]):
                    check(name, max_err(a, r_), 0.0)
                for name, a, r_ in zip(("kbuf", "vbuf", "cbuf"), out[4:7], ref[4:7]):
                    hold_leaf(f"{name}[:p+1]", a[:p + 1], r_[:p + 1],
                              TOL_BF16 if a.dtype == bf else 1e-6)
                hold_leaf("cc", out[7], ref[7], 1e-6)
                work = lazy_step_work(tok, taps, k_rings, state_q, s_scale, k_bufs, out, p)
                if b == BATCH and p == WINDOW - 1:
                    record(summary, "gla_decode_lazy_conv_int8", err_o, *timed[p], *work, bf)
                else:
                    note_shape("gla_decode_lazy_conv_int8", f"{tag} p{p}", *timed[p], *work, bf)
            k_rings, k_bufs = out[1:4], list(out[4:8])
            p_rings, p_bufs = ref[1:4], list(ref[4:8])

        ref_q, ref_sc = gla_cuda.gla_fold_q_plain(state_q, s_scale, *p_bufs)
        q_in, sc_in = state_q.clone(), s_scale.clone()
        new_q, new_sc = gla_cuda.gla_fold_q(q_in, sc_in, *k_bufs)
        torch.cuda.synchronize()
        require(new_q.data_ptr() == q_in.data_ptr() and new_sc.data_ptr() == sc_in.data_ptr()
                and new_q.dtype == torch.int8, "int8 state not folded in place")
        print(f"gla_fold_q {tag}:")
        steps = (new_q.int() - ref_q.int()).abs()
        top, off = int(steps.max()), int((steps > 0).sum())
        print(f"  int8 state: at most {top} integer steps from the plain version, {off} of "
              f"{steps.numel()} elements differ; {int((new_q != state_q).sum())} changed by "
              "the fold")
        require(top <= 1 and off <= 1e-3 * steps.numel(), "int8 state differs from the plain fold")
        require(bool(ref_q.any()) and not torch.equal(new_q, state_q), "the fold changed nothing")
        hold_leaf("s_scale", new_sc, ref_sc, 1e-5)
        err_s = hold_leaf("dequantized state", dequantize_state_rows(new_q, new_sc),
                          dequantize_state_rows(ref_q, ref_sc), TOL_BF16)
        ms, plain_ms = timed_pair(
            f"gla_fold_q {tag}", lambda: gla_cuda.gla_fold_q(*states(), *k_bufs),
            lambda: gla_cuda.gla_fold_q_plain(*states(), *k_bufs), 50)
        work = (nbytes(state_q, state_q, s_scale, s_scale, *k_bufs),
                b * H * DK * (DV * (2 * WINDOW + 4) + 2 * WINDOW))
        if b == BATCH:
            record(summary, "gla_fold_q", err_s, ms, plain_ms, *work, bf)
        else:
            note_shape("gla_fold_q", tag, ms, plain_ms, *work, bf)


def hold_launched_q_shapes(torch):
    """Every shape the driven paths gave int8_linear and fused_ffn_int8 so
    far is held against the plain version now, unless it was held before; a
    path that launched a kernel at a shape that disagrees fails here."""
    new = {name: sorted(Q_LAUNCHED[name] - Q_HELD[name], key=str) for name in Q_LAUNCHED}
    print(f"the quantized paths launched int8_linear on {len(Q_LAUNCHED['int8_linear'])} shapes "
          f"and fused_ffn_int8 on {len(Q_LAUNCHED['fused_ffn_int8'])}; not held yet: "
          f"{len(new['int8_linear'])} and {len(new['fused_ffn_int8'])}")
    for shape in new["int8_linear"]:
        hold_int8_linear(torch, shape)
    for shape in new["fused_ffn_int8"]:
        hold_fused_ffn(torch, shape)
    for name in Q_LAUNCHED:
        require(Q_LAUNCHED[name] and Q_LAUNCHED[name] <= Q_HELD[name],
                f"{name}: launched but not held: {Q_LAUNCHED[name] - Q_HELD[name]}")


def quant_generate_phase(torch, np, model, cfg, card_line):
    """The flagship of the generate phase with int8 weights, then with int8
    weights and int8 lazy-window states."""
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.attentive_rnn import add_lazy_buffers, map_state
    from lina_speech_tpu_torch.models.base_blocks import use_int8_weights
    from lina_speech_tpu_torch.utils.quantize import is_quantized_leaf, quantized_bytes

    rng = np.random.default_rng(0)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook, size=(1, BATCH, T_PROMPT))).to(DEVICE)
    n_pre = T_PROMPT + 1
    steps = MAX_SEQLEN - n_pre
    reset_counts()  # the kernel phase's launches are no path's
    total = dict.fromkeys(read_counts(), 0)

    # classic loop on int8 weights at b1 and b8: prefill at full precision
    for b in (1, BATCH):
        gen = torch.Generator(device=DEVICE).manual_seed(b)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = generate_batch(model, text[:b], gen, prompt=prompt[:, :b], max_seqlen=MAX_SEQLEN,
                             k=TOPK, force_max_seqlen=True, weight_quant="int8")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"generate_batch(weight_quant=\"int8\"): {b} requests, {res.n_steps} steps "
              f"({steps} decoded), {wall:.3f} s wall [{card_line}]")
        print(f"launches: {launches}")
        expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                        gla_decode_conv=N_GLA_LAYERS * steps,
                        int8_linear=INT8_LINEARS_PER_STEP * steps,
                        fused_ffn_int8=N_GLA_LAYERS * steps)
        require(res.tokens.shape == (cfg.n_quant, b, MAX_SEQLEN) and int(res.tokens.min()) >= 0
                and int(res.tokens.max()) < model.n_target_vocab, "int8 tokens out of range")
        require(not any(getattr(m, "use_int8", False) for m in model.modules()),
                "the int8 route stayed on after generate_batch")
        add_launches(total, launches)

    # lazy windows over int8 states, on int8 weights, greedy, b8
    windows = -(-(MAX_SEQLEN - n_pre) // WINDOW)
    lazy_steps = windows * WINDOW
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    lazy = generate_batch(model, text, prompt=prompt, max_seqlen=MAX_SEQLEN, k=1,
                          force_max_seqlen=True, lazy_window=WINDOW, weight_quant="int8",
                          state_quant="int8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"generate_batch(weight_quant=\"int8\", lazy_window={WINDOW}, state_quant=\"int8\"): "
          f"{BATCH} requests, {lazy.n_steps} steps ({windows} windows decoded), {wall:.3f} s "
          f"wall [{card_line}]")
    print(f"launches: {launches}")
    # the 24 layer states are int8; the pos_net's stays in the state dtype
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_lazy_conv=N_GLA_LAYERS * lazy_steps,
                    gla_decode_lazy_conv_int8=(N_GLA_LAYERS - 1) * lazy_steps,
                    gla_fold_q=(N_GLA_LAYERS - 1) * windows, gla_fold=windows,
                    int8_linear=INT8_LINEARS_PER_STEP * lazy_steps,
                    fused_ffn_int8=N_GLA_LAYERS * lazy_steps)
    require(lazy.tokens.shape == (cfg.n_quant, BATCH, MAX_SEQLEN) and int(lazy.tokens.min()) >= 0
            and int(lazy.tokens.max()) < model.n_target_vocab, "lazy int8 tokens out of range")
    add_launches(total, launches)

    # as generate_batch: the int8 copies and the float route in the compute
    # dtype, from copies of the parameters cast to it
    with model.using_params(model.cast_param_copies()):
        named = dict(model.named_parameters())
        tree = model.quantize_weights_()
        n_int8 = sum(is_quantized_leaf(v) for v in tree.values())
        print(f"resident weight bytes (quantized_bytes): {quantized_bytes(named)} as they are "
              f"(bf16), {quantized_bytes(tree)} with the {n_int8} quantized weights int8")
        require(n_int8 == INT8_LINEARS_PER_STEP + 2 * N_GLA_LAYERS + 2 * N_TEXT_LAYERS
                + N_TEXT_LAYERS + 1, f"{n_int8} weights were quantized")

        # one lazy window teacher-forced through the kernel path and the plain
        # path, both on int8 weights, from the same int8 states
        with torch.no_grad():
            x_enc = model.encode_text(text)
            start = model.embed_tokens(torch.ones(1, BATCH, 1, dtype=torch.long, device=DEVICE))
            forced = torch.cat([start, model.embed_tokens(prompt + cfg.n_special_token_in)], 1)
            follow = model.embed_tokens(lazy.tokens[:, :, n_pre:n_pre + WINDOW])
            st0 = model.prefill(forced, x_enc, model.empty_state(BATCH, DEVICE))[2]
            base = add_lazy_buffers(st0, WINDOW, dtype=model.dtype, state_quant="int8")
            runs = {}
            with use_int8_weights(model):
                for mode in ("auto", "chunk"):
                    set_kernel_mode(model, mode)
                    st = map_state(lambda t: t.clone(), base)
                    reset_counts()
                    logits = []
                    for p in range(WINDOW):
                        lg, _, st = model.decode_step(follow[:, p], x_enc, st, time_step=n_pre + p,
                                                      lazy_p=p)
                        require(bool(torch.isfinite(lg).all()), f"{mode}: non-finite logits, step {p}")
                        logits.append(lg)
                    st = model.fold_lazy_state(st)
                    counts = read_counts()
                    if mode == "chunk":
                        expect_launches(counts)
                    else:
                        require(counts["gla_fold_q"] == N_GLA_LAYERS - 1, "the kernel path's fold")
                    runs[mode] = (torch.stack(logits, 1), st)
                set_kernel_mode(model, "auto")
            torch.cuda.synchronize()
            print(f"one lazy window of {WINDOW} steps on int8 weights and int8 states, "
                  "teacher-forced, kernel path vs plain path:")
            check("logits", max_err(runs["auto"][0], runs["chunk"][0]),
                  bound(runs["chunk"][0], TOL_LOGITS))
            check_states("states after the fold, kernel path vs plain path", runs["auto"][1],
                         runs["chunk"][1], TOL_QPATH,
                         live=("s", "s_scale", "conv_q", "conv_k", "conv_v", "kbuf", "vbuf", "cbuf"))

            # ms per token, quantized beside unquantized, in turns
            def steps_ms(b, int8, lazy_mode):
                xe, f = x_enc[:b], follow[:b]
                s = model.prefill(forced[:b, :8], xe, model.empty_state(b, DEVICE))[2]
                if lazy_mode:
                    s = add_lazy_buffers(s, WINDOW, dtype=model.dtype,
                                         state_quant="int8" if int8 else None)
                torch.cuda.synchronize()
                t_0 = time.perf_counter()
                with use_int8_weights(model, on=int8):
                    for i in range(WINDOW):
                        s = model.decode_step(f[:, i], xe, s, lazy_p=i if lazy_mode else None)[2]
                    if lazy_mode:
                        s = model.fold_lazy_state(s)
                torch.cuda.synchronize()
                return (time.perf_counter() - t_0) * 1e3 / WINDOW

            cases = [(1, False, False), (1, True, False), (BATCH, False, False),
                     (BATCH, True, False), (BATCH, False, True), (BATCH, True, True)]
            times = {case: [] for case in cases}
            for case in cases:
                steps_ms(*case)  # warm
            for case in cases + cases[::-1]:
                times[case].append(steps_ms(*case))
            for (b, int8, lazy_mode), ms in times.items():
                what = ("int8 weights" + (" and int8 states" if lazy_mode else "")) if int8 else "bf16"
                print(f"decode b{b} {'lazy windows' if lazy_mode else 'classic'}, {what}: {ms} "
                      f"ms/token (kernel path, {WINDOW} steps) [{card_line}]")
            profile_int8_decode(torch, model, x_enc[:1], forced[:1], follow[:1])
    return total


def profile_int8_decode(torch, model, x_enc, forced, follow, steps=8):
    """torch.profiler over 8 classic decode steps at b1 on int8 weights:
    device busy share, and the device time in int8_linear, fused_ffn_int8,
    the GLA kernels and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from lina_speech_tpu_torch.models.base_blocks import use_int8_weights

    with use_int8_weights(model):
        st = model.prefill(forced[:, :8], x_enc, model.empty_state(1, DEVICE))[2]
        for i in range(2):
            st = model.decode_step(follow[:, i], x_enc, st)[2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                st = model.decode_step(follow[:, i], x_enc, st)[2]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(prof, f"{steps} decode steps b1, int8 weights", wall_ms, groups=(
        ("int8_linear", ("int8_linear_", "quantize_rows_kernel")),
        ("fused_ffn_int8", ("ffn_chunk_kernel", "ffn_sum_kernel")),
        ("GLA kernels", ("gla_",))))


def quant_serving_phase(torch, np, model, cfg, card_line):
    """DecodeServer on int8 weights and int8 lazy-window states: 12 requests
    through 8 recycled slots with prefill at full precision, then 4 requests
    through a server that keeps only the int8 weights (prefill and text
    encoding through the int8 route). The second server takes the float
    weights out of ``model``: nothing else may use it afterwards."""
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    requests = serving_requests(np, cfg)
    total = dict.fromkeys(read_counts(), 0)
    quant = dict(lazy=True, k=1, state_quant="int8", weight_quant="int8")
    short = [(text, prompt, (1 if prompt is None else 1 + prompt.shape[1]) + 2 * WINDOW)
             for text, prompt, _ in requests[:len(SERVE_PROMPTS)]]
    for full_precision, reqs in ((True, requests), (False, short)):
        mode = "lazy, int8 weights and states" + (
            "" if full_precision else ", prefill through the int8 weights")
        srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                           int8_prefill_full_precision=full_precision, **quant)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        done, n_chunks, chunk_ms = serve(torch, srv, reqs)
        wall = time.perf_counter() - t0
        launches = read_counts()
        n_tokens = sum(c.length for c in done.values())
        print(f"DecodeServer {mode}: {len(reqs)} requests through {SERVE_SLOTS} slots, "
              f"{n_chunks} decode chunks of {WINDOW}, {n_tokens} tokens, {wall:.3f} s wall "
              f"[{card_line}]")
        print(f"launches: {launches}")
        chunks = [_pow2_chunks(1 + (0 if p is None else p.shape[1])) for _, p, _ in reqs]
        later = sum(len(c) - 1 for c in chunks)
        # forwards on int8 weights: every decode step, and with the float
        # weights gone every prefill chunk and every text encoding too
        forwards = WINDOW * n_chunks + (0 if full_precision else len(reqs) + later)
        encodes = 0 if full_precision else N_TEXT_LAYERS * len(reqs)
        expect_launches(
            launches, gla_chunk_conv=N_GLA_LAYERS * len(reqs), gla_chunk=N_GLA_LAYERS * later,
            gla_decode_lazy_conv=N_GLA_LAYERS * WINDOW * n_chunks,
            gla_decode_lazy_conv_int8=(N_GLA_LAYERS - 1) * WINDOW * n_chunks,
            gla_fold_q=(N_GLA_LAYERS - 1) * n_chunks, gla_fold=n_chunks,
            int8_linear=INT8_LINEARS_PER_STEP * forwards + encodes,
            fused_ffn_int8=N_GLA_LAYERS * forwards + encodes)
        add_launches(total, launches)
        check_served(model, cfg, srv, reqs, done, chunks)
        report_chunk_times(mode, len(reqs), chunk_ms, card_line)
        for place, st in [("layer 0", srv._state.layers[0]), ("pos_net", srv._state.pos_net)]:
            quantized = place != "pos_net"
            require(st.s.dtype == (torch.int8 if quantized else model.dtype)
                    and (st.s_scale is not None) == quantized and bool(st.s.any())
                    and st.kbuf.dtype == model.dtype,
                    f"slot container, {place}: s {st.s.dtype}, kbuf {st.kbuf.dtype}")
        # the server launched no int8 kernel at a shape that was not held
        hold_launched_q_shapes(torch)
    require(model.logits_head.weight is None, "the float weights are still resident")
    return total


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
    print_profile(prof, f"{steps} decode steps b{BATCH}", wall_ms)


def print_profile(prof, what, wall_ms, top=8, groups=()):
    """Device busy share and the kernels with the most device time of a
    torch.profiler run (the profiler's own overhead is in the wall time).
    ``groups``: (label, substrings of kernel names) whose device time is
    summed and printed, with the rest."""
    from torch.autograd import DeviceType

    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # kernel and memcpy rows only: CPU-op rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy_ms = sum(dev(e) for e in events) / 1e3
    if not events:
        print("profiler: no device time recorded; device busy share not measured")
        return
    print(f"profiler, {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.4f} of wall)")
    for e in sorted(events, key=dev, reverse=True)[:top]:
        print(f"  {dev(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    rest = busy_ms
    for label, keys in groups:
        mine = [e for e in events if any(k in e.key for k in keys)]
        ms = sum(dev(e) for e in mine) / 1e3
        rest -= ms
        print(f"  {label}: {ms:.3f} ms in {sum(e.count for e in mine)} launches")
    if groups:
        print(f"  the rest: {rest:.3f} ms")


def profiled(torch, fn, what, top=8):
    """Run ``fn`` once under torch.profiler and print its device profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(prof, what, wall_ms, top)


GRAD_LEAVES = ("xq", "xk", "xv", "gk", "wq", "wk", "wv", "s0")


def check_grads(name, got, ref, rel, skip=lambda leaf: None, worst=None, named=()):
    """Every gradient leaf of ``got`` (a dict) against ``ref``: finite,
    non-zero, and within ``rel`` of that leaf's own max|ref| (no floor).
    ``skip(leaf)`` may return a bool mask of elements that are not held.
    Prints every leaf's error beside its max|ref| (or the ``worst`` ones and
    those whose name holds one of ``named``), fails after printing, and
    returns the largest error as a share of its leaf's max|ref|."""
    import torch

    rows, failed = [], []
    for leaf, r in ref.items():
        a = got[leaf]
        if a is None or a.shape != r.shape or a.dtype != r.dtype:
            failed.append(f"{leaf}: missing, or differs in shape or dtype")
            continue
        a, r = a.float(), r.float()
        mask = skip(leaf)
        if mask is not None:
            if bool(mask.all()):
                continue
            a, r = a[~mask], r[~mask]
        err, ref_max = float((a - r).abs().max()), float(r.abs().max())
        if not bool(torch.isfinite(a).all()):
            failed.append(f"{leaf}: not finite")
        if not (ref_max > 0 and float(a.abs().max()) > 0):
            failed.append(f"{leaf}: all zeros")
        if not err <= rel * ref_max:
            failed.append(f"{leaf}: max_abs_err {err} > {rel * ref_max}")
        rows.append((err / max(ref_max, 1e-30), err, ref_max, leaf))
    print(f"{name} (each leaf within {rel:.1e} of its own max|ref|):")
    rows.sort(reverse=True)
    shown = rows if worst is None else rows[:worst] + [
        r for r in rows[worst:] if any(n in r[3] for n in named)][:12]
    for share, err, ref_max, leaf in shown:
        print(f"  {leaf}: max_abs_err {err:.3e}, max|ref| {ref_max:.3e}, relative {share:.3e}")
    require(not failed, f"{name}: " + "; ".join(failed[:8]))
    print(f"  {len(rows)} leaves ok")
    return rows[0][0]


def conv_grads(torch, fn, x, do, dsf, need_ds0=True, need_taps=True):
    """(o, sf, gradients) of sum(o * do) + sum(sf * dsf) through ``fn`` (the
    wrapper or its plain version) w.r.t. its inputs: the initial state only
    where there is one and ``need_ds0``, the taps only with ``need_taps``."""
    wanted = [n for n in GRAD_LEAVES if x[n] is not None
              and (need_ds0 or n != "s0") and (need_taps or n not in ("wq", "wk", "wv"))]
    args = {n: x[n] if n not in wanted else x[n].detach().clone().requires_grad_(True)
            for n in GRAD_LEAVES}
    o, sf = fn(*(args[n] for n in GRAD_LEAVES[:7]), initial_state=args["s0"])
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    grads = torch.autograd.grad(loss, [args[n] for n in wanted])
    return o.detach(), sf.detach(), dict(zip(wanted, grads))


def bwd_flops(b, t):
    """Operations of the recurrent backward over t tokens: per token and
    head the state recomputed and read out for dq (5 DK DV) and the dS
    update, its decay, dk and dv (7 DK DV), plus the three convs forward and
    transposed and their tap sums (24 per channel)."""
    return b * H * t * (12 * DK * DV + 24 * (2 * DK + DV))


def hold_training_shape(torch, gla_cuda, b, t, st, need_ds0, need_taps):
    """gla_chunk_conv as a training path calls it (autograd recording, bf16
    IO) at one shape against its plain version: o, the final state and every
    gradient leaf. ``st`` is the initial state's dtype, or None for no
    initial state. Returns (inputs, do, dsf, gradients, largest error of a
    gradient leaf relative to its max|plain|)."""
    bf = torch.bfloat16
    need_ds0 = need_ds0 and st is not None
    x = kernel_inputs(torch, b, t, st, seed=300 + t)
    g = torch.Generator(device=DEVICE).manual_seed(t)
    do = torch.randn(b, H, t, DV, generator=g, device=DEVICE).to(bf)
    dsf = torch.randn(b, H, DK, DV, generator=g, device=DEVICE).to(st or torch.float32)
    before = read_counts()
    o_k, s_k, got = conv_grads(torch, gla_cuda.gla_chunk_conv, x, do, dsf, need_ds0, need_taps)
    after = read_counts()
    o_p, s_p, ref = conv_grads(torch, gla_cuda.gla_chunk_conv_plain, x, do, dsf, need_ds0,
                               need_taps)
    torch.cuda.synchronize()
    require(after["gla_chunk_conv_bwd"] == before["gla_chunk_conv_bwd"] + 1
            and after["gla_chunk_conv"] == before["gla_chunk_conv"] + 1,
            "the gradient did not go through the forward and backward kernels")
    state = "none" if st is None else str(st).split(".")[-1]
    name = (f"gla_chunk_conv b{b} t{t} initial state {state}"
            f"{'' if need_taps else ', no tap gradients'}"
            f"{'' if need_ds0 or st is None else ', no ds0'}")
    print(f"{name}, forward:")
    require(o_k.dtype == bf and s_k.dtype == s_p.dtype, "gla_chunk_conv output dtypes")
    check("o", max_err(o_k, o_p), bound(o_p, TOL_BF16))
    check("final state", max_err(s_k, s_p), bound(s_p, TOL_BF16 if st == bf else TOL_F32))
    worst = check_grads(f"{name}, backward", got, ref, TOL_GRAD)
    HELD.add((b, t, st, need_ds0, need_taps))
    return x, do, dsf, got, worst


def bwd_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk_conv's forward and hand-written backward vs the plain
    version and autograd through it at the training shape (b8 h4 dk256
    dv512, bf16 IO), t 512, 317 and 128, with an f32, a bf16 and no initial
    state; times at t512 with the bf16 state."""
    bf = torch.bfloat16
    for st in (torch.float32, bf, None):
        for t in TRAIN_T:
            x, do, dsf, got, worst = hold_training_shape(
                torch, gla_cuda, TRAIN_BATCH, t, st, True, True)
            if st != bf or t != TRAIN_T[0]:
                continue
            args = tuple(x[n] for n in GRAD_LEAVES[:7])
            with torch.no_grad():
                fwd_ms, fwd_plain_ms = timed_pair(
                    f"gla_chunk_conv forward t{t}",
                    lambda: gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"]),
                    lambda: gla_cuda.gla_chunk_conv_plain(*args, initial_state=x["s0"]), 5)
            o_k, s_k = gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
            fwd_bound, by = roofline(nbytes(*args, x["s0"], o_k, s_k),
                                     scan_flops(TRAIN_BATCH, t, True), bf)
            print(f"  gla_chunk_conv forward t{t}: kernel {fwd_ms:.6f} ms, plain "
                  f"{fwd_plain_ms:.6f} ms, bound {fwd_bound:.6f} ms by {by}")
            bwd = lambda: gla_cuda.gla_chunk_conv_bwd(*args, x["s0"], do, dsf)
            plain_both = lambda: conv_grads(torch, gla_cuda.gla_chunk_conv_plain, x, do, dsf)
            ms, plain = [], []
            for which in ("plain", "kernel", "kernel", "plain"):
                if which == "kernel":
                    ms.append(device_ms(bwd, 5))
                else:  # autograd's backward is not captured in a graph: eager
                    plain.append(eager_ms(plain_both, 3, warmup=1) - fwd_plain_ms)
            print(f"  gla_chunk_conv_bwd device ms: kernel {ms}; plain backward (eager forward "
                  f"and backward on the host's clock, less the plain forward) {plain}")
            mean = lambda xs: sum(xs) / len(xs)
            # the backward's max_abs_err is the largest error of a leaf as a
            # share of that leaf's max|plain|: the leaves' sizes differ 1e3-fold
            record(summary, "gla_chunk_conv_bwd", worst, mean(ms), mean(plain),
                   nbytes(*args, x["s0"], do, dsf, *got.values()),
                   bwd_flops(TRAIN_BATCH, t), bf)
            scratch = 2 * (DV // 32) * TRAIN_BATCH * H * t * DK * 4
            print(f"  scratch of one backward call: {scratch / 1e6:.1f} MB of dq/dk parts")
            profiled(torch, lambda: [bwd() for _ in range(3)],
                     f"3 calls of gla_chunk_conv_bwd t{t}", top=4)


def read_launches(gla_cuda):
    """The wrappers' launch counts, with the shapes the two training kernels
    were launched on since the last reset noted in LAUNCHED."""
    shapes = gla_cuda.launch_shapes()
    LAUNCHED.update(shapes["gla_chunk_conv_bwd"])
    require({s[:3] for s in shapes["gla_chunk_conv_bwd"]} == shapes["gla_chunk_conv"],
            f"forward and backward launched on different shapes: {shapes}")
    return read_counts()


def launched_shapes_phase(torch, gla_cuda):
    """Every (batch, length, initial state, wanted gradients) the training
    and tuning phases gave the forward and backward kernels is held against
    the plain version now, unless the backward kernel phase held it."""
    require(LAUNCHED, "the training and tuning phases noted no launch")
    new = sorted(LAUNCHED - HELD, key=str)
    print(f"the training and tuning phases launched gla_chunk_conv and its backward on "
          f"{len(LAUNCHED)} shapes, {len(new)} of them not held yet:")
    for b, t, st, need_ds0, need_taps in new:
        hold_training_shape(torch, gla_cuda, b, t, st, need_ds0, need_taps)
    require(LAUNCHED <= HELD, f"launched but not held: {sorted(LAUNCHED - HELD, key=str)}")


def zero_gradient_mask(torch, name, grad):
    """Elements whose gradient is zero in exact arithmetic, so that what a
    run computes there is rounding noise: the key-side bias of a softmax
    attention (adding a constant to every key moves no softmax), be it the
    bias of the key projection or of the norm in front of it."""
    mask = torch.zeros_like(grad, dtype=torch.bool)
    if name.endswith(("cross_att.ln_k.bias", "cross_att.k.bias")):
        mask[:] = True
    elif name.endswith("qkv.bias"):
        n = grad.shape[0] // 3
        mask[n:2 * n] = True
    return mask


def model_grads(torch, model, batch):
    """(loss, {name: gradient}) of the model's training forward."""
    model.zero_grad(set_to_none=True)
    loss = model(batch["text_token"], batch["audio_token"], batch["encoder_mask"],
                 batch["crossatt_mask"], logits_mask=batch["y_mask"])[1]
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def training_phase(torch, np, gla_cuda, card_line, cfg=None, fwd="gla_chunk_conv",
                   bwd="gla_chunk_conv_bwd", n_steps=TRAIN_STEPS, prepare=None):
    """A backbone at the flagship's width trains: ``n_steps`` optimizer
    steps at b8, the last with two micro-batches, then the kernel path
    against the plain path on a batch of 2 (the plain version's autograd
    saves several GB per layer at b8). ``cfg`` None is the flagship; its
    recurrent layers train through ``fwd`` and its backward ``bwd``.
    ``prepare(model)``, if given, runs on every model built here, right
    after build_model."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_169m
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    flagship = cfg is None
    cfg = lina_gla_169m(compute_dtype="bfloat16") if flagship else cfg
    prepare = prepare or (lambda m: None)
    model = build_model(cfg, device=DEVICE, seed=0)
    prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    require(not flagship or n_params == N_PARAMS, f"{n_params} parameters, expected {N_PARAMS}")
    require(all(p.dtype == torch.float32 for p in model.parameters()), "parameters not f32")
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, TrainConfig(n_warmup_steps=2, n_training_steps=100))
    steps = {1: make_train_step(model), 2: make_train_step(model, grad_accum_steps=2)}
    batches = synthetic_tts_batches(batch_size=TRAIN_BATCH, n_quant=cfg.n_quant,
                                    n_codebook=cfg.n_codebook, min_audio_len=MIN_AUDIO,
                                    max_audio_len=MAX_AUDIO, seed=0)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    total = dict.fromkeys(read_counts(), 0)
    torch.cuda.reset_peak_memory_stats()
    print(f"training {'the flagship' if flagship else cfg.backbone.kind}: {n_params:,} f32 "
          f"parameters, bf16 compute, batches of {TRAIN_BATCH}, audio length "
          f"{MIN_AUDIO}-{MAX_AUDIO}")
    for i in range(n_steps):
        accum = 2 if i == n_steps - 1 else 1
        batch = batch_to_device(next(batches), DEVICE)
        frames, padded = int(batch["y_mask"].sum()), batch["y_mask"].numel()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = steps[accum](state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_launches(gla_cuda)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"  step {i} (grad_accum_steps={accum}, lr {state.schedule(i):.2e}): loss "
              f"{loss:.4f}, grad_norm {norm:.4f}, acc_0 {float(metrics['acc_0']):.4f}, "
              f"{ms:.1f} ms, {frames} frames ({padded} padded, t {batch['y_mask'].shape[1]}) -> "
              f"{frames / ms * 1e3:.0f} frames/s [{card_line}]")
        require(np.isfinite(loss) and np.isfinite(norm) and norm > 0,
                f"step {i}: loss {loss}, grad_norm {norm}")
        expect_launches(launches, **{fwd: N_GLA_LAYERS * accum, bwd: N_GLA_LAYERS * accum})
        add_launches(total, launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory over the {n_steps} steps: {peak / 2**30:.2f} GiB "
          f"({peak} bytes) [{card_line}]")
    require(state.step == n_steps, f"{state.step} optimizer steps")
    still = [n for n, p in model.named_parameters()
             if not bool(torch.isfinite(p).all()) or torch.equal(p, start[n])]
    require(not still, f"parameters that did not move or are not finite: {still[:6]}")
    print(f"  all {len(start)} parameter tensors moved and are finite")
    del start
    batch = batch_to_device(next(batches), DEVICE)
    reset_counts()
    profiled(torch, lambda: steps[1](state, batch, gen),
             f"one train step b8 ({cfg.backbone.kind})", top=10)
    read_launches(gla_cuda)
    del state, steps
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # kernel path vs plain path: same weights, dropout off, a batch of 2. A
    # variant is compared on a copy built in f32 compute: simple-GLA's
    # per-head gate gradient sums dg over 256 key channels, and in bf16 the
    # paths' hidden streams part by bf16 steps that this sum turns into 5-9%
    # of small leaves (an H100 read 0.51 on a pos_net leaf of 1.3e-7); the
    # bf16 instantiations are held at the kernel's own level
    model.eval()
    if flagship:
        check_model = model
    else:
        check_model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                                  device=DEVICE, seed=0)
        prepare(check_model)
    small = batch_to_device(next(synthetic_tts_batches(
        batch_size=2, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook, min_audio_len=MIN_AUDIO,
        max_audio_len=MAX_AUDIO, seed=1)), DEVICE)
    reset_counts()
    loss_k, grads_k = model_grads(torch, check_model, small)
    expect_launches(read_launches(gla_cuda), **{fwd: N_GLA_LAYERS, bwd: N_GLA_LAYERS})
    set_kernel_mode(check_model, "chunk")
    reset_counts()
    loss_p, grads_p = model_grads(torch, check_model, small)
    expect_launches(read_counts())
    set_kernel_mode(check_model, "auto")
    torch.cuda.synchronize()
    print(f"{cfg.backbone.kind} training forward and backward ({check_model.dtype} compute), "
          f"kernel path vs plain path, batch of 2 (t {small['y_mask'].shape[1]}): loss "
          f"{loss_k:.6f} vs {loss_p:.6f}")
    check("loss", abs(loss_k - loss_p), 1e-2 * abs(loss_p))
    check_grads("parameter gradients, kernel path vs plain path", grads_k, grads_p,
                TOL_PARAM_GRAD, worst=6, named=("conv1d", "gk_proj"),
                skip=lambda leaf: zero_gradient_mask(torch, leaf, grads_p[leaf]))
    del grads_k, grads_p
    return model, cfg, total, check_model


def tuning_phase(torch, np, gla_cuda, model, cfg, card_line, fwd="gla_chunk_conv",
                 bwd="gla_chunk_conv_bwd", check_model=None):
    """Initial-state tuning on ``model`` (the flagship, or simple-GLA whose
    layers run ``fwd`` and its backward ``bwd``): rank 1, batch 2, grad_acc
    2, four micro-steps. The S0 gradients of the two paths are compared on
    ``check_model`` (default: ``model``; the training phase's f32 copy for a
    variant)."""
    check_model = model if check_model is None else check_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.train.harness import batch_to_device
    from lina_speech_tpu_torch.train.initial_state import (
        InitialStateTuningConfig, make_tuning_step, train_initial_state, tuning_leaves,
    )

    config = InitialStateTuningConfig(rank=1, batch_size=2, grad_acc=2)
    data = synthetic_tts_batches(batch_size=2, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
                                 min_audio_len=MIN_AUDIO, max_audio_len=MAX_AUDIO, seed=2,
                                 structured=True, speaker=1)
    batches = [batch_to_device(next(data), DEVICE) for _ in range(4)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_blocks = 2 * cfg.backbone.n_layer

    # one micro-step on each path from the same S0 params: the gradients
    grads = {}
    for mode in ("auto", "chunk"):
        set_kernel_mode(check_model, mode)
        params = check_model.attentive_rnn.init_state_tuning_params(
            torch.Generator(device=DEVICE).manual_seed(config.seed), rank=1, scale=config.scale)
        leaves = tuning_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        step = make_tuning_step(check_model, config, params,
                                torch.optim.Adam(leaves, lr=config.lr))
        reset_counts()
        step(0, batches[0])
        if mode == "auto":
            expect_launches(read_launches(gla_cuda), **{fwd: N_GLA_LAYERS, bwd: N_GLA_LAYERS})
        else:
            expect_launches(read_counts())
        grads[mode] = {f"block {i} {'kv'[j]}": leaf.grad
                       for i, p in enumerate(params) for j, leaf in enumerate(p)}
    set_kernel_mode(check_model, "auto")
    require(len(grads["auto"]) == 2 * n_blocks, f"{len(grads['auto'])} S0 gradient leaves")
    check_grads(f"S0 gradients of {n_blocks} blocks (the kernel's ds0), kernel path vs plain "
                "path", grads["auto"], grads["chunk"], TOL_PARAM_GRAD, worst=6)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tuned, losses = train_initial_state(model, batches, config)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = read_launches(gla_cuda)
    print(f"train_initial_state ({cfg.backbone.kind}): {len(batches)} micro-steps of batch 2, "
          f"{len(batches) // config.grad_acc} optimizer updates, losses "
          f"{[round(x, 4) for x in losses]}, {ms:.1f} ms per micro-step [{card_line}]")
    expect_launches(launches, **{fwd: N_GLA_LAYERS * len(batches),
                                 bwd: N_GLA_LAYERS * len(batches)})
    require(all(np.isfinite(x) for x in losses), f"losses {losses}")
    fresh = tuning_leaves(model.attentive_rnn.init_state_tuning_params(
        torch.Generator(device=DEVICE).manual_seed(config.seed), rank=1, scale=config.scale))
    moved = [bool(torch.isfinite(a).all()) and not torch.equal(a.detach(), b)
             for a, b in zip(tuning_leaves(tuned), fresh)]
    require(len(moved) == 2 * n_blocks and all(moved), "S0 params that did not move")
    require(all(p.grad is None for p in model.parameters()), "the model took a gradient")
    require(all(torch.equal(p, before[n]) for n, p in model.named_parameters()),
            "the model's parameters moved")
    print(f"  {len(moved)} S0 params moved; the model's {len(before)} tensors took no "
          "gradient and did not move")
    return launches


# ------------------------------------------- GLA layers without per-projection convs
def head_name(h, dk, dv):
    return f"h{h} dk{dk} dv{dv}"


def qkv_inputs(torch, b, h, t, dk, dv, io, st, seed):
    """Post-conv q, k, v in the IO dtype, f32 log-gates (slow decays, as a
    trained gate gives) and an initial state of dtype ``st`` (None: none)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    return dict(q=r(b, h, t, dk).to(io), k=r(b, h, t, dk).to(io), v=r(b, h, t, dv).to(io),
                gk=torch.nn.functional.logsigmoid(r(b, h, t, dk)) / 16,
                s0=None if st is None else r(b, h, dk, dv).to(st))


def plain_qkv_flops(b, h, t, dk, dv, backward=False):
    """Operations of the recurrence on post-conv q, k, v: per token and head
    a decay, a rank-1 update and a readout (5 dk dv); the backward adds the
    dS update, its decay, dk and dv (7 dk dv) to the recomputation."""
    return b * h * t * (12 if backward else 5) * dk * dv


def chunk_grads(torch, fn, x, do, dsf, scale, need_ds0):
    """(o, sf, gradients) of sum(o * do) + sum(sf * dsf) through ``fn``
    (gla_chunk or its plain version) w.r.t. q, k, v, gk, and s0 where there
    is one and ``need_ds0``."""
    names = ["q", "k", "v", "gk"] + (["s0"] if x["s0"] is not None and need_ds0 else [])
    args = {n: x[n] if n not in names else x[n].detach().clone().requires_grad_(True)
            for n in ("q", "k", "v", "gk", "s0")}
    o, sf = fn(args["q"], args["k"], args["v"], args["gk"], initial_state=args["s0"],
               scale=scale)
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    grads = torch.autograd.grad(loss, [args[n] for n in names])
    return o.detach(), sf.detach(), dict(zip(names, grads))


def hold_chunk(torch, gla_cuda, shape, need_ds0=None):
    """gla_chunk at ``shape`` = (b, h, t, dk, dv, IO dtype, initial-state
    dtype or None, scale) against its plain version: with ``need_ds0`` None
    the inference forward (o, final state); otherwise as training calls it
    (autograd recording: the forward kernel and the hand-written backward)
    against autograd through the plain version, o, the final state and
    every gradient leaf each within a share of its own max|plain|. Returns
    (inputs, do, dsf, gradients, worst gradient share)."""
    b, h, t, dk, dv, io, st, scale = shape
    x = qkv_inputs(torch, b, h, t, dk, dv, io, st, seed=400 + t + h)
    state = "none" if st is None else str(st).split(".")[-1]
    name = (f"gla_chunk b{b} {head_name(h, dk, dv)} t{t} IO {str(io).split('.')[-1]} "
            f"initial state {state} scale {scale:g}")
    tol = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    tol_s = TOL_BF16 if torch.bfloat16 in (io, st) else TOL_F32
    before = gla_cuda.launch_counts()
    if need_ds0 is None:
        with torch.no_grad():
            o_k, s_k = gla_cuda.gla_chunk(x["q"], x["k"], x["v"], x["gk"], x["s0"], scale=scale)
            o_p, s_p = gla_cuda.gla_chunk_plain(x["q"], x["k"], x["v"], x["gk"], x["s0"],
                                                scale=scale)
        result = None
    else:
        g = torch.Generator(device=DEVICE).manual_seed(t)
        do = torch.randn(b, h, t, dv, generator=g, device=DEVICE).to(io)
        dsf = torch.randn(b, h, dk, dv, generator=g, device=DEVICE).to(st or torch.float32)
        o_k, s_k, got = chunk_grads(torch, gla_cuda.gla_chunk, x, do, dsf, scale, need_ds0)
        o_p, s_p, ref = chunk_grads(torch, gla_cuda.gla_chunk_plain, x, do, dsf, scale,
                                    need_ds0)
        name += "" if need_ds0 or st is None else ", no ds0"
    after = gla_cuda.launch_counts()
    torch.cuda.synchronize()
    require(after["gla_chunk"] == before["gla_chunk"] + 1
            and after["gla_chunk_bwd"] == before["gla_chunk_bwd"] + (need_ds0 is not None),
            f"{name}: not launched through the kernels")
    print(f"{name}, forward:")
    require(o_k.dtype == io and s_k.dtype == (st or torch.float32), "gla_chunk output dtypes")
    check("o", max_err(o_k, o_p), bound(o_p, tol))
    check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
    CHUNK_HELD.add(shape)
    if need_ds0 is not None:
        worst = check_grads(f"{name}, backward", got, ref,
                            TOL_GRAD if torch.bfloat16 in (io, st) else TOL_F32)
        CHUNK_BWD_HELD.add((*shape, need_ds0 and st is not None))
        result = (x, do, dsf, got, worst)
    return result


def chunk_bwd_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk's forward and hand-written backward against the plain
    version and autograd through it at the training shapes: b8, t 512, 317
    and 128, with an f32, a bf16 and no initial state; simple-GLA's heads
    (bf16 IO) and Mamba-2's (f32 IO, scale 1.0). Times at t512 without an
    initial state (what training runs); the summary takes simple-GLA's."""
    bf, f32 = torch.bfloat16, torch.float32
    for (h, dk, dv), io, scale in ((SIMPLE_HEAD, bf, SIMPLE_HEAD[1] ** -0.5),
                                   (MAMBA_HEAD, f32, 1.0)):
        for st in (f32, bf, None):
            for t in TRAIN_T:
                shape = (TRAIN_BATCH, h, t, dk, dv, io, st, scale)
                x, do, dsf, got, worst = hold_chunk(torch, gla_cuda, shape, need_ds0=True)
                if st is not None or t != TRAIN_T[0]:
                    continue
                args = (x["q"], x["k"], x["v"], x["gk"])
                with torch.no_grad():
                    fwd_ms, fwd_plain_ms = timed_pair(
                        f"gla_chunk forward {head_name(h, dk, dv)} t{t}",
                        lambda: gla_cuda.gla_chunk(*args, scale=scale),
                        lambda: gla_cuda.gla_chunk_plain(*args, scale=scale), 5)
                    o_k, s_k = gla_cuda.gla_chunk(*args, scale=scale)
                note_shape("gla_chunk", f"training forward b{TRAIN_BATCH} {head_name(h, dk, dv)} "
                           f"t{t}", fwd_ms, fwd_plain_ms, nbytes(*args, o_k, s_k),
                           plain_qkv_flops(TRAIN_BATCH, h, t, dk, dv), io)
                bwd = lambda: gla_cuda.gla_chunk_bwd(*args, None, do, dsf, scale)
                plain_both = lambda: chunk_grads(torch, gla_cuda.gla_chunk_plain, x, do, dsf,
                                                 scale, True)
                ms, plain = [], []
                for which in ("plain", "kernel", "kernel", "plain"):
                    if which == "kernel":
                        ms.append(device_ms(bwd, 5))
                    else:  # autograd's backward is not captured in a graph: eager
                        plain.append(eager_ms(plain_both, 3, warmup=1) - fwd_plain_ms)
                print(f"  gla_chunk_bwd {head_name(h, dk, dv)} device ms: kernel {ms}; plain "
                      f"backward (eager forward and backward on the host's clock, less the "
                      f"plain forward) {plain}")
                mean = lambda xs: sum(xs) / len(xs)
                work = (nbytes(*args, do, dsf, *got.values()),
                        plain_qkv_flops(TRAIN_BATCH, h, t, dk, dv, backward=True), io)
                if h == SIMPLE_HEAD[0]:
                    record(summary, "gla_chunk_bwd", worst, mean(ms), mean(plain), *work)
                else:
                    note_shape("gla_chunk_bwd", f"b{TRAIN_BATCH} {head_name(h, dk, dv)} t{t} "
                               "IO float32 scale 1", mean(ms), mean(plain), *work)
                scratch = 2 * (dv // 32) * TRAIN_BATCH * h * t * dk * 4
                print(f"  scratch of one backward call: {scratch / 1e6:.1f} MB of dq/dk parts")
    reset_counts()  # the kernel phases' launches are no path's


def hold_decode(torch, gla_cuda, shape, summary=None, timed=False):
    """gla_decode at ``shape`` = (b, h, dk, dv, IO dtype, state dtype)
    against gla_decode_plain: o and the state, updated in place. ``timed``:
    kernel and plain on a rotation of cold states (100 MB), beside the bound;
    into the summary at ``summary``'s shape, else a further shape."""
    b, h, dk, dv, io, st = shape
    x = qkv_inputs(torch, b, h, 1, dk, dv, io, st, seed=500 + b + h)
    tok = tuple(x[n][:, :, 0].contiguous() for n in ("q", "k", "v", "gk"))
    s = x["s0"]
    before = gla_cuda.launch_counts()["gla_decode"]
    o_p, s_p = gla_cuda.gla_decode_plain(*tok, s)
    s_in = s.clone()
    o_k, s_k = gla_cuda.gla_decode(*tok, s_in)
    torch.cuda.synchronize()
    require(gla_cuda.launch_counts()["gla_decode"] == before + 1, "gla_decode not launched")
    require(s_k.data_ptr() == s_in.data_ptr(), "state not updated in place")
    tag = f"b{b} {head_name(h, dk, dv)} IO {str(io).split('.')[-1]} state {str(st).split('.')[-1]}"
    print(f"gla_decode {tag}:")
    tol = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    err_o = max_err(o_k, o_p)
    check("o", err_o, bound(o_p, tol))
    check("state", max_err(s_k, s_p), bound(s_p, TOL_BF16 if torch.bfloat16 in (io, st)
                                                  else TOL_F32))
    DECODE_HELD.add(shape)
    if not timed:
        return
    states = cold_pool(s_p)
    ms, plain_ms = timed_pair(f"gla_decode {tag}", lambda: gla_cuda.gla_decode(*tok, states()),
                              lambda: gla_cuda.gla_decode_plain(*tok, states()), 50)
    work = (nbytes(*tok, s, s, o_k), plain_qkv_flops(b, h, 1, dk, dv), io)
    if summary is not None:
        record(summary, "gla_decode", err_o, ms, plain_ms, *work)
    else:
        note_shape("gla_decode", tag, ms, plain_ms, *work)


def decode_kernel_phase(torch, gla_cuda, summary):
    """gla_decode (one token without convs) against its plain version at
    b1, b8 and b64 for simple-GLA's heads (bf16 IO) and at b8 for Mamba-2's
    (f32 IO), with bf16 and f32 states, timed on cold states. The summary
    takes b8 simple-GLA with its f32 state (what the driven path runs)."""
    bf, f32 = torch.bfloat16, torch.float32
    for b, (h, dk, dv), io in [(b, SIMPLE_HEAD, bf) for b in (1, BATCH, 64)] + [
            (BATCH, MAMBA_HEAD, f32)]:
        for st in (bf, f32):
            main = (b, h, io, st) == (BATCH, SIMPLE_HEAD[0], bf, f32)
            hold_decode(torch, gla_cuda, (b, h, dk, dv, io, st),
                        summary=summary if main else None, timed=True)
    reset_counts()  # the kernel phases' launches are no path's


def variant_cfg(kind, **backbone):
    """The flagship config (bf16 compute, 12 + 12 layers and the blind
    pos_net at d 1024) with another backbone kind or options."""
    from lina_speech_tpu_torch.config import lina_gla_169m

    cfg = lina_gla_169m(compute_dtype="bfloat16")
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, kind=kind,
                                                                  **backbone))


def teacher_forced_check(torch, model, cfg, text, prompt, tokens, card_line, tol):
    """The prefill of ``prompt`` and 16 decode steps that follow ``tokens``
    (a generate_batch result), teacher-forced through the kernel path and
    the plain path: logits within ``tol[0]`` of max(1, max|plain|), layer
    0's state (the same input on both paths) within ``tol[1]`` and every
    state leaf within ``tol[2]`` of its own max|plain|; times of both."""
    live = ("h", "conv") if cfg.backbone.kind == "mamba2" else ("s",)
    n_pre = T_PROMPT + 1
    kind = f"{cfg.backbone.kind} ({str(model.dtype).split('.')[-1]} compute)"
    tol_logits, tol_first, tol_state = tol
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
        x_enc = model.encode_text(text)
        start = model.embed_tokens(torch.ones(1, BATCH, 1, dtype=torch.long, device=DEVICE))
        forced = torch.cat([start, model.embed_tokens(prompt + cfg.n_special_token_in)], 1)
        follow = model.embed_tokens(tokens[:, :, n_pre:n_pre + TF_STEPS])
        runs = {}
        for mode in ("auto", "chunk", "chunk", "auto"):
            set_kernel_mode(model, mode)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_pre, _, st = model.prefill(forced, x_enc, model.empty_state(BATCH, DEVICE))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits = [logits_pre[:, -1]]
            for i in range(TF_STEPS):
                lg, _, st = model.decode_step(follow[:, i], x_enc, st, time_step=n_pre + i)
                logits.append(lg)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if mode == "chunk":
                expect_launches(read_counts())
            runs.setdefault(mode, dict(logits=torch.stack(logits, 1), state=st, pre=[], dec=[]))
            runs[mode]["pre"].append((t1 - t0) * 1e3)
            runs[mode]["dec"].append((t2 - t1) * 1e3 / TF_STEPS)
        set_kernel_mode(model, "auto")
    ref = runs["chunk"]["logits"]
    print(f"{kind} teacher-forced logits (prefill + {TF_STEPS} steps), kernel vs plain path:")
    check("logits", max_err(runs["auto"]["logits"], ref), bound(ref, tol_logits))
    # the first layer reads the same embeddings on both paths: its state is
    # the kernels' own difference; deeper layers add the bf16 steps by which
    # the paths' hidden streams part (an H100 reads 1e-2 of a leaf's max at
    # layer 5 and 2.7e-2 at layer 23 for simple-GLA), as a chunked prefill
    # does against the one-shot prefill
    field = live[0]
    first = [getattr(runs[m]["state"].layers[0], field) for m in ("auto", "chunk")]
    print(f"{kind} layer 0 {field} (the same input on both paths), kernel vs plain path:")
    check(field, max_err(*first), tol_first * float(first[1].float().abs().max()))
    check_states(f"{kind} states after prefill + {TF_STEPS} steps, kernel path vs plain path",
                 runs["auto"]["state"], runs["chunk"]["state"], tol_state, live=live)
    for mode, name in (("auto", "kernel"), ("chunk", "plain")):
        r = runs[mode]
        print(f"{kind} {name} path: prefill b{BATCH} t{n_pre} {r['pre']} ms, decode "
              f"{r['dec']} ms/token (b{BATCH}, host clock) [{card_line}]")


def variant_generate_phase(torch, np, gla_cuda, model, cfg, card_line, lazy,
                           chunk="gla_chunk", decode="gla_decode",
                           tol_path=(TOL_LOGITS, TOL_BF16, TOL_STATE), f32_copy=None):
    """generate_batch at the flagship's width for a backbone whose layers
    run the prefill kernel ``chunk`` and the decode kernel ``decode``
    (gla_chunk and gla_decode, or RWKV6's two): 8 requests (32 text tokens, a 150-code
    prompt, top-k 100, 200 steps) with the classic loop and, with ``lazy``,
    greedy in lazy windows of 16 (the plain lazy step, the gla_fold kernel);
    launch counts; then the prefill and 16 decode steps teacher-forced
    through the kernel path and the plain path: logits and every state leaf
    of the two, each within a share of its own magnitude (``tol_path``, as
    :func:`teacher_forced_check`), and the same on ``f32_copy`` (the model
    built in f32 compute), if given, within TOL_F32."""
    from lina_speech_tpu_torch.generate import generate_batch

    kind = cfg.backbone.kind
    rng = np.random.default_rng(0)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook, size=(1, BATCH, T_PROMPT))).to(DEVICE)
    n_pre = T_PROMPT + 1
    steps = MAX_SEQLEN - n_pre
    total = dict.fromkeys(read_counts(), 0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, torch.Generator(device=DEVICE).manual_seed(0),
                         prompt=prompt, max_seqlen=MAX_SEQLEN, k=TOPK, force_max_seqlen=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"{kind} generate_batch: {BATCH} requests, {res.n_steps} steps ({steps} decoded), "
          f"{wall:.3f} s wall [{card_line}]")
    print(f"launches: {launches}")
    expect_launches(launches, **{chunk: N_GLA_LAYERS, decode: N_GLA_LAYERS * steps})
    require(res.tokens.shape == (cfg.n_quant, BATCH, MAX_SEQLEN) and int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < model.n_target_vocab, "tokens out of range")
    add_launches(total, launches)
    if lazy:
        windows = -(-steps // WINDOW)
        reset_counts()
        t0 = time.perf_counter()
        res_l = generate_batch(model, text, prompt=prompt, max_seqlen=MAX_SEQLEN, k=1,
                               force_max_seqlen=True, lazy_window=WINDOW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"{kind} generate_batch(lazy_window={WINDOW}): {BATCH} requests, {windows} "
              f"windows, {wall:.3f} s wall [{card_line}]; launches {launches}")
        expect_launches(launches, gla_chunk=N_GLA_LAYERS, gla_fold=N_GLA_LAYERS * windows)
        require(int(res_l.tokens.min()) >= 0 and int(res_l.tokens.max()) < model.n_target_vocab,
                "lazy tokens out of range")
        add_launches(total, launches)

    teacher_forced_check(torch, model, cfg, text, prompt, res.tokens, card_line, tol_path)
    if f32_copy is not None:
        teacher_forced_check(torch, f32_copy, cfg, text, prompt, res.tokens, card_line,
                             (TOL_F32,) * 3)
    return total


def variant_serving_phase(torch, np, gla_cuda, model, cfg, card_line, chunk="gla_chunk",
                          decode="gla_decode"):
    """DecodeServer on simple-GLA without convs (or RWKV6): 8 requests
    through 8 slots in classic mode (prefill chunks all on ``chunk``, tokens
    on ``decode``), launch counts against the formula."""
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    reqs = serving_requests(np, cfg)[:SERVE_CLASSIC_REQUESTS]
    srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW, k=1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done, n_chunks, chunk_ms = serve(torch, srv, reqs)
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_tokens = sum(c.length for c in done.values())
    print(f"{cfg.backbone.kind} DecodeServer classic: {len(reqs)} requests through "
          f"{SERVE_SLOTS} slots, {n_chunks} decode chunks of {WINDOW}, {n_tokens} tokens, "
          f"{wall:.3f} s wall [{card_line}]")
    print(f"launches: {launches}")
    n_prefill = sum(len(_pow2_chunks(1 + (0 if p is None else p.shape[1]))) for _, p, _ in reqs)
    expect_launches(launches, **{chunk: N_GLA_LAYERS * n_prefill,
                                 decode: N_GLA_LAYERS * WINDOW * n_chunks})
    for (_, _, max_len), c in zip(reqs, (done[r] for r in sorted(done))):
        require(c.tokens.shape == (c.length, cfg.n_quant) and c.length <= max_len
                and (c.stopped or c.length == max_len), f"request {c.rid}: length {c.length}")
        require(int(c.tokens.min()) >= 0 and int(c.tokens.max()) < model.n_target_vocab,
                f"request {c.rid}: tokens out of range")
    report_chunk_times("classic", len(reqs), chunk_ms, card_line)
    return launches


def simple_gla_phase(torch, np, gla_cuda, card_line):
    """Simple-GLA without convs at the flagship's width (lina_gla_169m with
    kind="simple_gla", use_short_conv=False: 4 heads, dk 256, dv 256, random
    weights, bf16 compute): generate_batch classic and lazy, a DecodeServer,
    five train steps and four S0 tuning micro-steps."""
    from lina_speech_tpu_torch.config import build_model

    cfg = variant_cfg("simple_gla", use_short_conv=False)
    model = build_model(cfg, device=DEVICE, seed=0)
    heads = {(m.num_heads, m.head_qk_dim, m.head_v_dim) for m in model.attentive_rnn.gla_layers()}
    print(f"simple-GLA (no convs): {sum(p.numel() for p in model.parameters()):,} parameters, "
          f"heads {heads}")
    require(len(model.attentive_rnn.gla_layers()) == N_GLA_LAYERS and heads == {SIMPLE_HEAD},
            f"simple-GLA layers {heads}")
    total = variant_generate_phase(torch, np, gla_cuda, model, cfg, card_line, lazy=True)
    add_launches(total, variant_serving_phase(torch, np, gla_cuda, model, cfg, card_line))
    del model
    torch.cuda.empty_cache()
    model, cfg, train, check_model = training_phase(
        torch, np, gla_cuda, card_line, cfg, "gla_chunk", "gla_chunk_bwd",
        VARIANT_TRAIN_STEPS["simple_gla"])
    add_launches(total, train)
    add_launches(total, tuning_phase(torch, np, gla_cuda, model, cfg, card_line, "gla_chunk",
                                     "gla_chunk_bwd", check_model))
    del model, check_model
    torch.cuda.empty_cache()
    return total


def mamba2_phase(torch, np, gla_cuda, card_line):
    """Mamba-2 at the flagship's width (kind="mamba2": d_inner 2048, 32
    heads of headdim 64, d_state 64): generate_batch at b8 and three train
    steps, with the same checks."""
    from lina_speech_tpu_torch.config import build_model

    cfg = variant_cfg("mamba2")
    model = build_model(cfg, device=DEVICE, seed=0)
    mixers = [m.tmix for m in model.modules() if type(m).__name__ == "MixingBlock"
              and type(m.tmix).__name__ == "Mamba2Mixer"]
    heads = {(m.n_heads, m.d_state, m.headdim) for m in mixers}
    print(f"Mamba-2: {sum(p.numel() for p in model.parameters()):,} parameters, "
          f"{len(mixers)} mixers, heads {heads}")
    require(len(mixers) == N_GLA_LAYERS and heads == {MAMBA_HEAD}, f"Mamba-2 mixers {heads}")
    total = variant_generate_phase(torch, np, gla_cuda, model, cfg, card_line, lazy=False)
    del model
    torch.cuda.empty_cache()
    model, _, train, check_model = training_phase(torch, np, gla_cuda, card_line, cfg,
                                                  "gla_chunk", "gla_chunk_bwd",
                                                  VARIANT_TRAIN_STEPS["mamba2"])
    add_launches(total, train)
    del model, check_model
    torch.cuda.empty_cache()
    return total


def interleaved_and_pp_phase(torch, np, gla_cuda, card_line):
    """The interleaved CrossAttGLA (cross-attention after layers 5 and 11 of
    one stack of 12) and the CrossAttentionPP backbone at the flagship's
    width, short convs on (the conv-fused kernels): one greedy
    generate_batch of 16 tokens at b2 each, launch counts, and the two conv
    kernels held against their plain versions at b2 with these backbones'
    f32 states."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.generate import generate_batch

    total = dict.fromkeys(read_counts(), 0)
    rng = np.random.default_rng(3)
    for label, backbone in (
            ("interleaved CrossAttGLA", dict(cross_att_layers=INTERLEAVED_LAYERS, blind=False)),
            ("CrossAttentionPP", dict(cross_att_pp=True, blind=False))):
        cfg = variant_cfg("gla", **backbone)
        # one stack of n_layer blocks; or 2 n_layer blocks and the inter_net
        n_layers = cfg.backbone.n_layer * (1 if "cross_att_layers" in backbone else 2)
        n_layers += "cross_att_pp" in backbone
        model = build_model(cfg, device=DEVICE, seed=0)
        require(len(model.attentive_rnn.gla_layers()) == n_layers, f"{label}: GLA layers")
        text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(SHORT_BATCH, TEXT_LEN)))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = generate_batch(model, text.to(DEVICE), max_seqlen=1 + SHORT_STEPS, k=1,
                             force_max_seqlen=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"{label}: {sum(p.numel() for p in model.parameters()):,} parameters, "
              f"generate_batch b{SHORT_BATCH} {SHORT_STEPS} tokens, {wall:.3f} s wall "
              f"[{card_line}]; launches {launches}")
        expect_launches(launches, gla_chunk_conv=n_layers, gla_decode_conv=n_layers * SHORT_STEPS)
        require(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < model.n_target_vocab,
                f"{label}: tokens out of range")
        add_launches(total, launches)
        del model
        torch.cuda.empty_cache()
    # the conv kernels at the shapes these runs gave them: b2, t1, f32 state
    x = kernel_inputs(torch, SHORT_BATCH, 1, torch.float32, seed=600)
    args = (x["xq"], x["xk"], x["xv"], x["gk"], x["wq"], x["wk"], x["wv"])
    o_k, s_k = gla_cuda.gla_chunk_conv(*args)
    o_p, s_p = gla_cuda.gla_chunk_conv_plain(*args)
    dec = (x["xq"][:, :, 0].contiguous(), x["xk"][:, :, 0].contiguous(),
           x["xv"][:, :, 0].contiguous(), x["gk"][:, :, 0].contiguous(),
           *(w.reshape(H, -1, 4).permute(2, 0, 1).contiguous() for w in (x["wq"], x["wk"], x["wv"])),
           *x["rings"])
    out_p = gla_cuda.gla_decode_conv_plain(*dec, x["s0"])
    out_k = gla_cuda.gla_decode_conv(*dec, x["s0"].clone())
    torch.cuda.synchronize()
    print(f"gla_chunk_conv and gla_decode_conv b{SHORT_BATCH} t1, f32 state:")
    check("prefill o", max_err(o_k, o_p), bound(o_p, TOL_BF16))
    check("prefill final state", max_err(s_k, s_p), bound(s_p, TOL_F32))
    check("decode o", max_err(out_k[0], out_p[0]), bound(out_p[0], TOL_BF16))
    check("decode state", max_err(out_k[1], out_p[1]), bound(out_p[1], TOL_F32))
    return total


def launched_gla_shapes_phase(torch, gla_cuda):
    """Every shape the driven paths launched gla_chunk (forward), its
    backward and gla_decode on is held against the plain version now,
    unless a kernel phase held it already."""
    fwd = sorted(GLA_LAUNCHED["gla_chunk"] - CHUNK_HELD, key=str)
    bwd = sorted(GLA_LAUNCHED["gla_chunk_bwd"] - CHUNK_BWD_HELD, key=str)
    # (the holds below launch the kernels too, but read no counts: GLA_LAUNCHED
    # keeps only what the driven paths launched)
    dec = sorted(GLA_LAUNCHED["gla_decode"] - DECODE_HELD, key=str)
    print(f"the driven paths launched gla_chunk on {len(GLA_LAUNCHED['gla_chunk'])} shapes "
          f"({len(fwd)} not held yet), its backward on {len(GLA_LAUNCHED['gla_chunk_bwd'])} "
          f"({len(bwd)}), gla_decode on {len(GLA_LAUNCHED['gla_decode'])} ({len(dec)})")
    require(all(GLA_LAUNCHED.values()), f"a kernel launched on no shape: {GLA_LAUNCHED}")
    for shape in bwd:
        hold_chunk(torch, gla_cuda, shape[:-1], need_ds0=shape[-1])
    for shape in sorted(GLA_LAUNCHED["gla_chunk"] - CHUNK_HELD, key=str):
        hold_chunk(torch, gla_cuda, shape)
    for shape in dec:
        hold_decode(torch, gla_cuda, shape)
    require(GLA_LAUNCHED["gla_chunk"] <= CHUNK_HELD
            and GLA_LAUNCHED["gla_chunk_bwd"] <= CHUNK_BWD_HELD
            and GLA_LAUNCHED["gla_decode"] <= DECODE_HELD, "launched but not held")


# ------------------------------------------------------------------- RWKV6
RWKV6_LEAVES = ("r", "k", "v", "w", "u", "s0")


def dtype_name(dt) -> str:
    return "none" if dt is None else str(dt).split(".")[-1]


def rwkv6_inputs(torch, b, h, t, dk, dv, io, st, seed):
    """r, k, v in the IO dtype; f32 log-decays spread as a trained RWKV6
    layer's (-exp(N(-2, 0.5))) with hard resets (-20, a packed batch's
    segment starts) at 5% of the steps; an f32 bonus u ~ N(0, 0.5); an
    initial state of dtype ``st`` (None: none). A decode token takes step 0."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    w = -torch.exp(r(b, h, t, dk) * 0.5 - 2.0)
    w = torch.where(torch.rand(b, 1, t, 1, generator=g, device=DEVICE) < 0.05, -20.0, w)
    return dict(r=r(b, h, t, dk).to(io), k=r(b, h, t, dk).to(io), v=r(b, h, t, dv).to(io),
                w=w.contiguous(), u=r(h, dk) * 0.5,
                s0=None if st is None else r(b, h, dk, dv).to(st))


def rwkv6_flops(b, h, t, dk, dv, backward=False):
    """Operations of the RWKV6 recurrence over t tokens: per token and head
    a decay, a rank-1 update and a readout of the (dk x dv) state (5 dk dv)
    and the bonus (u k, r . u k and its share of v: 3 dk + 2 dv); the
    backward adds the dS update, its decay, dk and dv (7 dk dv) to the
    recomputation, and the bonus's gradients."""
    per = (12 if backward else 5) * dk * dv + (2 if backward else 1) * (3 * dk + 2 * dv)
    return b * h * t * per


def rwkv6_grads(torch, fn, x, do, dsf, need_ds0):
    """(o, sf, gradients) of sum(o * do) + sum(sf * dsf) through ``fn``
    (rwkv6_chunk or its plain version) w.r.t. r, k, v, w, u, and s0 where
    there is one and ``need_ds0``."""
    names = list(RWKV6_LEAVES[:5]) + (["s0"] if x["s0"] is not None and need_ds0 else [])
    args = {n: x[n] if n not in names else x[n].detach().clone().requires_grad_(True)
            for n in RWKV6_LEAVES}
    o, sf = fn(*(args[n] for n in RWKV6_LEAVES[:5]), initial_state=args["s0"])
    loss = (o.float() * do.float()).sum() + (sf.float() * dsf.float()).sum()
    grads = torch.autograd.grad(loss, [args[n] for n in names])
    return o.detach(), sf.detach(), dict(zip(names, grads))


def hold_rwkv6_chunk(torch, rwkv6_cuda, shape, need_ds0=None):
    """rwkv6_chunk at ``shape`` = (b, h, t, dk, dv, IO dtype, initial-state
    dtype or None) against its plain version: with ``need_ds0`` None the
    inference forward (o, final state); otherwise as training calls it
    (autograd recording: the forward kernel and the hand-written backward)
    against autograd through the plain version, o, the final state and
    every gradient leaf (dr, dk, dv, dw, du, and ds0 where wanted), each
    within a share of its own max|plain|, finite and non-zero. Returns
    (inputs, do, dsf, gradients, worst gradient share); the last four None
    for the inference forward."""
    b, h, t, dk, dv, io, st = shape
    x = rwkv6_inputs(torch, b, h, t, dk, dv, io, st, seed=700 + t + b)
    name = (f"rwkv6_chunk b{b} {head_name(h, dk, dv)} t{t} IO {dtype_name(io)} "
            f"initial state {dtype_name(st)}")
    tol = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    tol_s = TOL_BF16 if torch.bfloat16 in (io, st) else TOL_F32
    args = tuple(x[n] for n in RWKV6_LEAVES[:5])
    before = rwkv6_cuda.launch_counts()
    result = (x, None, None, None, None)
    if need_ds0 is None:
        with torch.no_grad():
            o_k, s_k = rwkv6_cuda.rwkv6_chunk(*args, initial_state=x["s0"])
            o_p, s_p = rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])
    else:
        g = torch.Generator(device=DEVICE).manual_seed(t)
        do = torch.randn(b, h, t, dv, generator=g, device=DEVICE).to(io)
        dsf = torch.randn(b, h, dk, dv, generator=g, device=DEVICE).to(st or torch.float32)
        o_k, s_k, got = rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk, x, do, dsf, need_ds0)
        o_p, s_p, ref = rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk_plain, x, do, dsf, need_ds0)
        name += "" if need_ds0 or st is None else ", no ds0"
    after = rwkv6_cuda.launch_counts()
    torch.cuda.synchronize()
    require(after["rwkv6_chunk"] == before["rwkv6_chunk"] + 1
            and after["rwkv6_chunk_bwd"] == before["rwkv6_chunk_bwd"] + (need_ds0 is not None),
            f"{name}: not launched through the kernels")
    print(f"{name}, forward:")
    require(o_k.dtype == io and s_k.dtype == (st or torch.float32), "rwkv6_chunk output dtypes")
    check("o", max_err(o_k, o_p), bound(o_p, tol))
    check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
    RWKV6_HELD["rwkv6_chunk"].add(shape)
    if need_ds0 is not None:
        worst = check_grads(f"{name}, backward", got, ref,
                            TOL_GRAD if torch.bfloat16 in (io, st) else TOL_F32)
        RWKV6_HELD["rwkv6_chunk_bwd"].add((*shape, need_ds0 and st is not None))
        result = (x, do, dsf, got, worst)
    return result


def hold_rwkv6_decode(torch, rwkv6_cuda, shape, summary=None, timed=False):
    """rwkv6_decode at ``shape`` = (b, h, dk, dv, IO dtype, state dtype)
    against rwkv6_decode_plain: o and the state, updated in place.
    ``timed``: kernel and plain on a rotation of cold states (100 MB),
    beside the bound; into the summary at ``summary``'s shape, else a
    further shape."""
    b, h, dk, dv, io, st = shape
    x = rwkv6_inputs(torch, b, h, 1, dk, dv, io, st, seed=800 + b)
    tok = tuple(x[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w"))
    u, s = x["u"], x["s0"]
    before = rwkv6_cuda.launch_counts()["rwkv6_decode"]
    o_p, s_p = rwkv6_cuda.rwkv6_decode_plain(*tok, u, s)
    s_in = s.clone()
    o_k, s_k = rwkv6_cuda.rwkv6_decode(*tok, u, s_in)
    torch.cuda.synchronize()
    require(rwkv6_cuda.launch_counts()["rwkv6_decode"] == before + 1, "rwkv6_decode not launched")
    require(s_k.data_ptr() == s_in.data_ptr() and s_k.dtype == st, "state not updated in place")
    tag = f"b{b} {head_name(h, dk, dv)} IO {dtype_name(io)} state {dtype_name(st)}"
    print(f"rwkv6_decode {tag}:")
    err_o = max_err(o_k, o_p)
    check("o", err_o, bound(o_p, TOL_BF16 if io == torch.bfloat16 else TOL_F32))
    check("state", max_err(s_k, s_p), bound(s_p, TOL_BF16 if torch.bfloat16 in (io, st)
                                                  else TOL_F32))
    RWKV6_HELD["rwkv6_decode"].add(shape)
    if not timed:
        return
    states = cold_pool(s_p)
    ms, plain_ms = timed_pair(f"rwkv6_decode {tag}",
                              lambda: rwkv6_cuda.rwkv6_decode(*tok, u, states()),
                              lambda: rwkv6_cuda.rwkv6_decode_plain(*tok, u, states()), 50)
    work = (nbytes(*tok, u, s, s, o_k), rwkv6_flops(b, h, 1, dk, dv), io)
    if summary is not None:
        record(summary, "rwkv6_decode", err_o, ms, plain_ms, *work)
    else:
        note_shape("rwkv6_decode", tag, ms, plain_ms, *work)


def rwkv6_kernel_phase(torch, rwkv6_cuda, summary):
    """The three RWKV6 kernels against their plain versions at the
    flagship-width RWKV6 heads (h4 dk256 dv256, bf16 IO, f32 w and u):
    the forward at b8 t151 (generate's prefill), b1 t128 and b1 t1 (server
    prefill chunks), with an f32 and with no initial state; forward and
    backward at b8 t512 (training) with and without one, all six gradient
    leaves; the decode token at b1, b8 and b64 with f32 and bf16 states on
    cold states. Every time beside its bound. The summary takes the forward
    at b8 t151 with an f32 state (what generate launches), the backward at
    b8 t512 without one (what training launches) and the decode token at b8
    with an f32 state."""
    bf, f32 = torch.bfloat16, torch.float32
    h, dk, dv = RWKV6_HEAD
    for b, t in ((BATCH, T_PROMPT + 1), (1, 128), (1, 1)):
        for st in (f32, None):
            shape = (b, h, t, dk, dv, bf, st)
            x = hold_rwkv6_chunk(torch, rwkv6_cuda, shape)[0]
            args = tuple(x[n] for n in RWKV6_LEAVES[:5])
            with torch.no_grad():
                ms, plain_ms = timed_pair(
                    f"rwkv6_chunk b{b} t{t} initial state {dtype_name(st)}",
                    lambda: rwkv6_cuda.rwkv6_chunk(*args, initial_state=x["s0"]),
                    lambda: rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"]), 5)
                o_k, s_k = rwkv6_cuda.rwkv6_chunk(*args, initial_state=x["s0"])
                o_p = rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])[0]
            work = (nbytes(*args, x["s0"], o_k, s_k), rwkv6_flops(b, h, t, dk, dv), bf)
            if (b, st) == (BATCH, f32):
                record(summary, "rwkv6_chunk", max_err(o_k, o_p), ms, plain_ms, *work)
            else:
                note_shape("rwkv6_chunk", f"b{b} t{t} initial state {dtype_name(st)}", ms,
                           plain_ms, *work)
    t = TRAIN_T[0]
    for st in (f32, None):
        x, do, dsf, got, worst = hold_rwkv6_chunk(torch, rwkv6_cuda,
                                                  (TRAIN_BATCH, h, t, dk, dv, bf, st), True)
        if st is not None:
            continue
        args = tuple(x[n] for n in RWKV6_LEAVES[:5])
        with torch.no_grad():
            fwd_ms, fwd_plain_ms = timed_pair(
                f"rwkv6_chunk training forward b{TRAIN_BATCH} t{t}",
                lambda: rwkv6_cuda.rwkv6_chunk(*args),
                lambda: rwkv6_cuda.rwkv6_chunk_plain(*args), 5)
            o_k, s_k = rwkv6_cuda.rwkv6_chunk(*args)
        note_shape("rwkv6_chunk", f"training forward b{TRAIN_BATCH} t{t} initial state none",
                   fwd_ms, fwd_plain_ms, nbytes(*args, o_k, s_k),
                   rwkv6_flops(TRAIN_BATCH, h, t, dk, dv), bf)
        bwd = lambda: rwkv6_cuda.rwkv6_chunk_bwd(*args, None, do, dsf, need_ds0=False)
        plain_both = lambda: rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk_plain, x, do, dsf, False)
        ms, plain = [], []
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                ms.append(device_ms(bwd, 5))
            else:  # autograd's backward is not captured in a graph: eager
                plain.append(eager_ms(plain_both, 3, warmup=1) - fwd_plain_ms)
        print(f"  rwkv6_chunk_bwd device ms: kernel {ms}; plain backward (eager forward and "
              f"backward on the host's clock, less the plain forward) {plain}")
        mean = lambda xs: sum(xs) / len(xs)
        # max_abs_err: the largest error of a leaf as a share of its max|plain|
        record(summary, "rwkv6_chunk_bwd", worst, mean(ms), mean(plain),
               nbytes(*args, do, dsf, *got.values()),
               rwkv6_flops(TRAIN_BATCH, h, t, dk, dv, backward=True), bf)
        scratch = (2 * (dv // 32) * TRAIN_BATCH * h * t * dk
                   + (dv // 32) * TRAIN_BATCH * h * t) * 4
        print(f"  scratch of one backward call: {scratch / 1e6:.1f} MB of dr/dk/vdo parts")
        profiled(torch, lambda: [bwd() for _ in range(3)],
                 f"3 calls of rwkv6_chunk_bwd b{TRAIN_BATCH} t{t}", top=6)
    for b in (1, BATCH, 64):
        for st in (bf, f32):
            hold_rwkv6_decode(torch, rwkv6_cuda, (b, h, dk, dv, bf, st),
                              summary=summary if (b, st) == (BATCH, f32) else None, timed=True)
    reset_counts()  # the kernel phases' launches are no path's


def rwkv6_phase(torch, np, gla_cuda, card_line):
    """RWKV6 at the flagship's width (lina_gla_169m with kind="rwkv6",
    291,117,378 parameters, random weights from seed 0 with the bonus, the
    ddlerp mixes and the decays drawn off their constant inits, bf16
    compute, f32 states): generate_batch for 8 requests (classic loop;
    rwkv6_chunk for the prefill, rwkv6_decode for each token) with the
    kernel path held against the plain path under teacher forcing (in bf16,
    and on a copy built in f32 compute), a
    DecodeServer in classic mode (8 requests, 8 slots) and three train
    steps at b8 (rwkv6_chunk and its backward), the kernel path's loss and
    parameter gradients held against the plain path's on a batch of 2.
    RWKV6 has no lazy window and no S0 tuning, as in JAX."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.models.rwkv6 import RWKV6Attention, perturb_rwkv6_params_

    cfg = variant_cfg("rwkv6")
    prepare = lambda m: perturb_rwkv6_params_(m, torch.Generator().manual_seed(0))
    model = build_model(cfg, device=DEVICE, seed=0)
    prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    layers = [m for m in model.modules() if isinstance(m, RWKV6Attention)]
    heads = {(m.num_heads, m.head_k_dim, m.head_v_dim) for m in layers}
    state = model.empty_state(1, DEVICE).layers[0]
    print(f"RWKV6: {n_params:,} parameters, {len(layers)} layers, heads {heads}, state "
          f"{state.s.dtype}, shift {state.shift.dtype}")
    require(n_params == N_RWKV6_PARAMS, f"{n_params} parameters, expected {N_RWKV6_PARAMS}")
    require(len(layers) == N_GLA_LAYERS and heads == {RWKV6_HEAD}, f"RWKV6 layers {heads}")
    require(state.s.dtype == torch.float32, "RWKV6 states not f32")
    names = dict(chunk="rwkv6_chunk", decode="rwkv6_decode")
    f32_copy = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device=DEVICE,
                           seed=0)
    prepare(f32_copy)
    total = variant_generate_phase(torch, np, gla_cuda, model, cfg, card_line, lazy=False,
                                   tol_path=(TOL_RWKV6_PATH, TOL_BF16, TOL_RWKV6_PATH),
                                   f32_copy=f32_copy, **names)
    del f32_copy
    add_launches(total, variant_serving_phase(torch, np, gla_cuda, model, cfg, card_line, **names))
    del model
    torch.cuda.empty_cache()
    model, _, train, check_model = training_phase(
        torch, np, gla_cuda, card_line, cfg, "rwkv6_chunk", "rwkv6_chunk_bwd",
        VARIANT_TRAIN_STEPS["rwkv6"], prepare=prepare)
    add_launches(total, train)
    del model, check_model
    torch.cuda.empty_cache()
    return total


def launched_rwkv6_shapes_phase(torch, rwkv6_cuda):
    """Every shape the driven RWKV6 paths launched the three RWKV6 kernels
    on is held against the plain version now, unless the RWKV6 kernel phase
    held it already."""
    todo = {n: sorted(RWKV6_LAUNCHED[n] - RWKV6_HELD[n], key=str) for n in RWKV6_LAUNCHED}
    print("the driven RWKV6 paths launched " + ", ".join(
        f"{n} on {len(RWKV6_LAUNCHED[n])} shapes ({len(todo[n])} not held yet)" for n in todo))
    require(all(RWKV6_LAUNCHED.values()), f"an RWKV6 kernel launched on no shape: {RWKV6_LAUNCHED}")
    for shape in todo["rwkv6_chunk_bwd"]:
        hold_rwkv6_chunk(torch, rwkv6_cuda, shape[:-1], need_ds0=shape[-1])
    for shape in sorted(RWKV6_LAUNCHED["rwkv6_chunk"] - RWKV6_HELD["rwkv6_chunk"], key=str):
        hold_rwkv6_chunk(torch, rwkv6_cuda, shape)
    for shape in todo["rwkv6_decode"]:
        hold_rwkv6_decode(torch, rwkv6_cuda, shape)
    require(all(RWKV6_LAUNCHED[n] <= RWKV6_HELD[n] for n in RWKV6_LAUNCHED),
            "RWKV6: launched but not held")


def main():
    import numpy as np
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on a GPU only")
    from lina_speech_tpu_torch.ops import _build, gla_cuda, rwkv6_cuda

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
    quant_linear_kernel_phase(torch, summary)
    quant_lazy_kernel_phase(torch, gla_cuda, summary)
    add_launches(launches, quant_generate_phase(torch, np, model, cfg, card_line))
    add_launches(launches, quant_serving_phase(torch, np, model, cfg, card_line))
    del model
    torch.cuda.empty_cache()
    bwd_kernel_phase(torch, gla_cuda, summary)
    model, cfg, train_launches, _ = training_phase(torch, np, gla_cuda, card_line)
    add_launches(launches, train_launches)
    add_launches(launches, tuning_phase(torch, np, gla_cuda, model, cfg, card_line))
    launched_shapes_phase(torch, gla_cuda)
    del model
    torch.cuda.empty_cache()
    chunk_bwd_kernel_phase(torch, gla_cuda, summary)
    decode_kernel_phase(torch, gla_cuda, summary)
    add_launches(launches, simple_gla_phase(torch, np, gla_cuda, card_line))
    add_launches(launches, mamba2_phase(torch, np, gla_cuda, card_line))
    add_launches(launches, interleaved_and_pp_phase(torch, np, gla_cuda, card_line))
    launched_gla_shapes_phase(torch, gla_cuda)
    rwkv6_kernel_phase(torch, rwkv6_cuda, summary)
    add_launches(launches, rwkv6_phase(torch, np, gla_cuda, card_line))
    launched_rwkv6_shapes_phase(torch, rwkv6_cuda)
    kernels = []
    for name, source, replaces in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **summary[name],
                            shapes=OTHER_SHAPES.get(name, [])))
    print(f"chip_smoke wall time {time.perf_counter() - started:.1f} s [{card_line}]")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
