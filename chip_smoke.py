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
   the classic decode step, the lazy-window step (b 1, 8 and 64, window 16,
   stale garbage in the dead slots; on its planned route along the window
   and on the other at p 0, 7 and 15, both timed there, equal bits on a
   second call) and the window fold, and a whole lazy window against 16
   classic steps; the lazy step's two routes timed in turns at b 1 to 16,
   p 0, 7 and 15, bf16 and f32 states, beside the route its plan picks
   (lazy_route_sweep); the classic step's planned route (gla_decode_plan:
   the tile body on states up to 512 KiB, above them a wide column-tile
   body of 4, 8 or 16 threads across a row) and the one it is timed against
   (the tile body, or the wide route) in turns at b 1 to 64, bf16 and f32
   states, for the flagship's conv step, simple-GLA's and Mamba-2's steps,
   the planned one no more than SWEEP_MARGIN slower (decode_route_sweep);
   the two folds' band heights timed in turns at b 1, 8 and 64 on the
   flagship's head (bf16, f32 and int8 states) and at b8 on simple-GLA's and
   Mamba-2's, beside the band gla_fold_plan picks (fold_route_sweep);
   max error beside its tolerance, both
   times, and each kernel's roofline bound. The two prefill kernels are
   held on both routes of their forward (gla_chunk_fwd_plan: the chunked
   tensor-core route for bf16 IO from 64 tokens on, 128 above 8 heads in
   flight with dv below 512, the recurrent body below), the chunked route
   also against its own plain version, at b1 t151
   also under adversarial gates; the two routes are timed against each
   other at b8 t151 and b1 t151 down to t1, where the chunked route must be
   the faster wherever the plan takes it, and over a sweep of lengths up to
   128 at b1, b2 and b8, where it must be no more than SWEEP_MARGIN slower;
4. generate phase: the flagship Lina-GLA (359,302,978 parameters, random
   weights from seed 0, bf16 compute and state) serves 8 requests through
   generate_batch (32 text tokens and a 150-code prompt each, top-k 100,
   200 steps), first with the classic token loop, then with lazy_window=16;
   the kernel launch counts of each run are checked; then the prefill and
   16 decode steps are teacher-forced through the kernel path and the plain
   path, and their logits and times compared;
5. serving phase: DecodeServer with 8 slots and chunks of 16 serves 12
   requests (prompts of 150, 97, 33 and 0 codes, max_len 168-232, so slots
   are recycled) in lazy mode, then 8 requests in classic mode (four decode
   chunks past each prompt), one
   run(max_chunks=1) call at a time; completions, prefill chunk sizes (each
   one a shape the kernel phase checked) and launch counts are checked, the
   5-chunk prefill against the one-shot prefill, and the server's logits and
   final states on the kernel path against the plain path under teacher
   forcing, every state tensor within a share of its own magnitude;
6. backward kernel phase: gla_chunk_conv as training calls it (autograd
   recording: the forward kernel, and the hand-written backward behind a
   torch.autograd.Function; bf16 IO takes its chunked route, four
   tensor-core kernels and the conv's finishing pass) against the plain
   version and autograd through it at the training shape b 8, t 512, 317 and
   128, bf16 IO, with an f32, a bf16 and no initial state, random do and
   dsf, and at t 512 with adversarial gates (-6 to -8 a step in every sixth
   key channel): o and the final state (on both forward routes, the chunked
   one also against its plain version), and all eight gradient leaves, each
   within a share of its own max|plain|, finite and non-zero; forward (both
   routes) and backward times beside their bounds and the plain version's,
   the scratch of each, equal bits on a second call of each and profiles
   of three forward and three backward calls by kernel;
7. training phase: the flagship at full depth and width (f32 parameters,
   bf16 compute, dropout 0.1 in the text encoder) takes five optimizer steps
   of make_train_step on synthetic batches of 8 (audio length 128-512), the
   last with grad_accum_steps=2; loss and grad_norm finite, launch counts per
   micro-batch 25 forward and 25 backward and nothing else, every forward
   on its planned route (chunked), every backward on the chunked route,
   every parameter moved; on a batch of 2 the kernel
   path against the plain path: loss and every parameter's gradient (finite,
   each within a share of its own max|plain|); ms per step, frames per
   second, peak memory, and a profiled step's device busy share with the
   GLA kernels' device time;
8. tuning phase: initial-state tuning on the flagship through
   train_initial_state (rank 1, batch 2, grad_acc 2, two optimizer updates):
   the model takes no gradient and does not move, each of the 48 S0 params
   has a finite non-zero gradient (the kernel's ds0, chunked route), held
   against the plain path on one micro-step;
8a. CLI phase: ``python -m lina_speech_tpu_torch.train.cli fit`` run
   in-process on configs/lina_gla_169m.yaml as it stands (the flagship,
   synthetic b8, audio 128-512) for 3 steps with --log-every 1 and a
   checkpoint directory: 359,302,978 parameters, finite losses and grad
   norms, 25 + 25 launches a step; the final checkpoint restored onto the
   card equal to the live state bit for bit (parameters, both Adam moments,
   the step); --resume --steps 4 starts at step 3 and writes step_4; the
   directory (about 4.3 GB a checkpoint) is removed at the end;
8b. data phase: 16 WAV files made from a seed (2-6 s, PCM16 and float32,
   two at 16 kHz named <name>@16000.wav) through
   scripts/prepare_dataset_torch.py on the card into two npz shards with
   the full-width codec (random weights from a seed); every row's codes
   equal the card codec's encode and are held against the same codec on
   the CPU as the pipeline phase holds codes; fit trains the flagship two
   steps on data.kind npz over those shards (a YAML written by the phase,
   the flagship's model section unchanged);
8c. remat phase: the flagship built twice from seed 0, backbone.remat off
   and on, one training forward and backward each on one b8 t512 batch with
   one generator state: 25 forward and 25 backward launches without remat,
   49 (25 + 24 recomputed; the pos_net is not rematerialized) and 25 with
   it; parameter gradients equal bit for bit (a second run without remat
   gives the spread to fall back on if a kernel proves non-deterministic);
   the peak device memory and warm ms of both, and a profile of each;
9. launched shapes phase: every (batch, length, initial state, wanted
   gradients) on which phases 7 to 8c launched the forward and backward
   kernels is held against the plain version as in phase 6, so no shape
   that trained went unchecked at the kernel's own level.
After phase 5, on the flagship of phase 4, the TTS pipeline (pipeline_phase):
5p. TTSPipeline with WavTokenizerConfig() (the 320_24k codec at full width,
   73,784,690 parameters, random weights from seed 11, f32, TF32 off):
   (a) tokenize_audio turns 2 s of seeded noise at 24 kHz, b8, into 150
   prompt frames; the latents are held against the same module on the CPU
   (TOL_CODEC of their own max|ref|) and the codes must be equal but where
   the CPU's two scores are closer than the latents' difference can move
   them; (b) synthesize at b8 with those prompts (max_seqlen 200) and at b1
   without one (max_seqlen 100), top-k 100: launch counts 25 gla_chunk_conv and 25
   gla_decode_conv a decoded step, every waveform finite, non-zero and
   frames x 320 long, the wall ms and seconds of speech a second of each
   run and the share of it that vocoding takes; (c) every row's waveform
   and one row's backbone output against the CPU's on the same codes, and
   a control decode of that row with TF32 on that must miss TOL_CODEC;
   (d) stream_synthesize through a one-slot server (a 150-frame prompt:
   later prefill chunks on gla_chunk), its chunks equal to vocode_streaming
   on the final codes it returns; (e) device ms of the vocoder at b1 x 750
   and b8 x 200 frames beside its f32 bound, and of the encoder at b1 x
   3 s. Each step prints its seconds, and the phase its total.
Between phases 5 and 6, on the flagship of phase 4, quantized serving:
5a. quantized kernel phase: int8_linear (both modes) at m 1, 8, 64 and 128
   for every (K, N) of the flagship's quantized layers, fused_ffn_int8 at m
   1, 8 and 64, the lazy step over an int8 state (b 1, 8 and 64, p 0, 7, 15,
   on the tile route, its only body; the cluster route must refuse it) and
   the requantizing fold gla_fold_q, each against its plain version (int8
   states by integers, at most one step apart, and by their scales); times
   on a rotation of cold weights and states beside the bounds and beside
   the bf16 library call the int8 stream has to beat;
5b. quantized generate phase: generate_batch(weight_quant="int8") with the
   classic loop at b 8 and generate_batch(weight_quant="int8",
   lazy_window=16, state_quant="int8") at b 8, launch counts against a
   formula written from the model's structure; one lazy window
   teacher-forced through the kernel path and the plain path (finite logits
   at every step, every state leaf, the int8 states by integers); ms per
   token at b 8 quantized beside unquantized, resident weight bytes, and a profile
   of 8 decode steps at b 1 with int8 weights;
5c. quantized serving phase: DecodeServer(lazy=True, state_quant="int8",
   weight_quant="int8") serves 12 requests (two decode chunks past each
   prompt) through 8 recycled slots, then a
   server with int8_prefill_full_precision=False (the float weights leave
   the model) serves 4; every shape those runs gave int8_linear and
   fused_ffn_int8 is held against the plain version, or the phase fails.
Between phases 5b and 5c, int4 lazy-window states (two values a byte):
5d. int4 kernel phase: the int4 bodies of gla_decode_lazy_conv (its tile
   route; the cluster route must refuse an int4 state) and gla_fold_q over
   whole windows at b 1, 8 and 64 against their plain versions (o within
   TOL_BF16 of its own max, rings, live slots and cc equal, equal bits on a
   second call; the fold's nibbles at most one step apart in at most 1e-3
   of them, against the plain version and the plain mirror of the kernel's
   bf16-part update, scales to 1e-5), timed on a rotation of cold states
   beside the bound;
5e. int4 generate phase: generate_batch(lazy_window=16, state_quant="int4")
   at b 8 with 150-code prompts, one window teacher-forced through the
   kernel path and the plain path (logits, every state leaf, the int4
   states by their nibbles), a lazy DecodeServer(state_quant="int4") with
   8 slots over 8 requests with 150-code prompts (its slot container's s
   dv / 2 bytes a row), launch counts against their formulas, and every
   int4 shape launched held.
After phase 8c:
8d. codec GAN phase: python -m lina_speech_tpu_torch.train.codec_cli fit
   in-process at the full 320_24k width (73,784,690 generator parameters,
   MPD and MRD), batch 2 x 24,000 samples of seeded noise, 3 steps, a
   validation pass and a checkpoint: finite losses, the parameters moved,
   the checkpoint equal to the trained generator, ms a step and peak
   memory.
After phase 9, the GLA layers without per-projection convs:
10. gla_chunk's forward and backward and the two classic steps against
   their plain versions (the steps on every route, the wide ones also
   against their split plain versions; gla_decode_conv at b64, gla_decode
   at b1, b8, b64 and Mamba-2's b8): the backward at b8 t 512, 317 and
   128 with an f32, a bf16 and no initial state for simple-GLA's heads
   (bf16 IO: autograd's launch on the planned route, then both routes
   forced, the chunked one also against its plain decomposition,
   gla_chunk_bwd_chunked_plain) and
   Mamba-2's (f32 IO, the recurrent route), simple-GLA's also at the tuning
   batch b2 and under adversarial gates; every leaf within a share of its
   own max|plain|, finite and non-zero; a route sweep of the backward at
   b1, b2 and b8 over t 16-512 (the chunked route, which the plan takes for
   bf16 IO from 48 tokens, no more than SWEEP_MARGIN slower); times at b8
   t512 on both routes beside the bound, the plain version and each
   route's scratch, equal bits on a second call and a profile of three
   calls by kernel; then simple-GLA, Mamba-2, the interleaved and the PP backbones at
   the flagship's width through their paths, every bf16 gla_chunk_bwd
   launch of simple-GLA's training and tuning on the chunked route, and
   simple-GLA's bf16 parameter gradients with every backward chunked held
   against every backward forced onto the recurrent body within
   TOL_PARAM_GRAD; every shape launched held;
then RWKV6:
11. RWKV6 kernel phase: rwkv6_chunk, its hand-written backward and
   rwkv6_decode against their plain versions at h4 dk256 dv256 (bf16 IO,
   f32 w and u): the forward at b8 t151, b1 t128 and b1 t1 with an f32 and
   with no initial state and at b8 t512 with none, on both routes of
   rwkv6_chunk_fwd_plan (the chunked tensor-core route of
   rwkv6_chunked_fwd.cuh, also against its own plain version, and the
   recurrent body; each tensor within a share of its own max|plain|),
   forward and backward at b8 t512 with and
   without one (dr, dk, dv, dw, du, ds0; the backward on both routes of
   rwkv6_chunk_bwd_plan, the chunked tensor-core route of
   rwkv6_chunked_bwd.cuh also against its own plain version, each route
   twice for equal bits), the decode token at b1, b8 and
   b64 with f32 and bf16 states on cold states on every body of
   rwkv6_decode_plan (the classic step's tile body and its wide column-tile
   bodies, equal state bits on every body and on a second call), the
   planned body and the one it is timed against in turns; the forward's two routes in
   turns at b8 t512, b8 t151 and b1 t128 and over a sweep of b 1-8 and t
   16-192, the backward's at b8 t512 (beside its bound, the plain
   version's time and each route's scratch, and a profile of three calls)
   and over a sweep of b 1-8 and t 16-512, where the planned route may be
   at most SWEEP_MARGIN slower; every time beside its bound;
12. RWKV6 phase: kind="rwkv6" at the flagship's width (291,117,378
   parameters, random weights from seed 0 with u, the ddlerp mixes and the
   decays drawn off their constant inits; bf16 compute, f32 states):
   generate_batch for the 8 requests of phase 4 (classic loop), the kernel
   path held against the plain path under teacher forcing (logits, s and
   shift of every layer), a DecodeServer in classic mode (8 requests, four
   decode chunks past each prompt, 8
   slots) and three train steps at b8, the kernel path's loss and
   gradients held against the plain path's on a batch of 2, and the bf16
   model's parameter gradients with one layer's backward at a time on the
   chunked route against every one on the recurrent body within
   TOL_PARAM_GRAD (rwkv6_layer_route_grad_check);
   launch counts 25 rwkv6_decode per token, 25 rwkv6_chunk and 25
   rwkv6_chunk_bwd per micro-batch, every rwkv6_chunk and rwkv6_chunk_bwd
   launch on its planned route (every bf16 backward at or above the
   threshold chunked); then every shape those runs launched the three
   kernels on is held against the plain versions (rwkv6_chunk on the route
   it took, the backward on both routes, rwkv6_decode on every body), and
   timed on both routes for rwkv6_chunk's and rwkv6_chunk_bwd's launches x
   (time - bound), the planned route at most SWEEP_MARGIN slower, and
   rwkv6_decode's on the planned body and the tile body in turns, the
   planned one the faster (decode_gap_phase);
then Mamba (v1):
13. Mamba kernel phase: mamba_scan and its hand-written backward against
   their plain versions (the time loop, and autograd through it) at d 2048,
   n 16 (bf16 x, B and C; f32 dt, A, D and states): the forward at b8 t151
   with an f32 and with no initial state and at b1 for every server chunk
   length down to t1, on both routes of mamba_scan_plan (one walk, and
   time cut into chunks that run in parallel, each also against
   mamba_scan_chunked_plain; equal bits on a second call); forward and
   backward at b8 t512 with an initial
   state, without one and with a reset mask (dx, ddt, dA, dB, dC, dD, ds0),
   every output and leaf within a share of its own max|plain|, finite and
   non-zero, the backward on both routes of mamba_scan_bwd_plan (one chunk,
   and time cut into chunks that run in parallel, the latter also against
   mamba_scan_bwd_chunked_plain), each twice for equal bits; every time
   beside its bound (bytes, f32 operations, or the exponentials at the SFU
   rate of the card's highest SM clock), the backward's two routes timed in
   turns with their scratch and a profile of three calls; a chunk-length
   sweep of the forward and of the backward at b 1-8, t 16-512 and the
   ragged lengths the paths launch, where the planned length may be at most
   SWEEP_MARGIN slower than the fastest (mamba_fwd_route_sweep,
   mamba_bwd_route_sweep);
14. Mamba phase: kind="mamba" at the flagship's width (314,976,578
   parameters, random weights from seed 0 with A_log, D and dt_proj's bias
   drawn off their inits; bf16 compute, f32 states): generate_batch for the
   8 requests of phase 4 (classic loop), the kernel path held against the
   plain path under teacher forcing (logits, h and conv of every layer; in
   bf16 and on an f32-compute copy), a classic DecodeServer (8 requests,
   four decode chunks past each prompt, 8
   slots) and three train steps at b8, the kernel path's loss and gradients
   held against the plain path's on a batch of 2; launch counts 25
   mamba_scan per prefill and per server prefill chunk, 25 mamba_scan and 25
   mamba_scan_bwd per micro-batch, none per decode token; then the
   interleaved CrossAttMamba (cross-attention after layers 5 and 11) through
   a 16-token generate and one train step (every backward at its planned
   chunk length); then every shape those runs launched the two kernels on is
   held against the plain versions (each kernel on both routes) and timed
   on both routes for launches x (time - bound), a chunked launch also a
   segment either side of its chunk length, each also had every launch
   taken one chunk (mamba_gap_phase).
After the interleaved and PP backbones (phase 10), the last two model kinds:
15. CFG and speaker-encoder phase (cfg_spk_phase): the flagship with
   mask_text_p=0.1 and SpeakerEncoderConfig() (dim_inner 256, 4 heads, 6
   layers, window 256), bf16 compute and state: generate_batch(cfg_coef=3.0)
   at b4 with 150-code prompts, greedy, 64 steps (the kernels at b8; 25
   gla_chunk_conv and 25 gla_decode_conv a step); on a copy built in f32
   compute: cfg_coef=1.0 against the unguided run token for token (32
   steps), the doubled batch teacher-forced through the kernel path and the
   plain path (teacher_forced_check), and the guided logits of two requests
   (prefill and 16 steps, the speaker vector on the prompt) against the
   same model on the CPU within TOL_F32 of max|ref|; a 4-slot DecodeServer(cfg_coef=3.0) over 4
   requests (8 device rows) whose greedy tokens equal each request's
   guided generate_batch with the speaker encoder set aside (the server
   does not run it), launch counts, and every f32 shape it gave
   gla_chunk_conv held against the plain version; TTSPipeline.synthesize(
   cfg_coef=3.0) at b4 with the full-width codec, its wall and seconds of
   speech a second;
16. transformer phase (transformer_phase): kind="transformer" at d 1024,
   12 blocks of 4 heads, cross-attention after block 6, the flagship's text
   encoder, bf16 compute: its parameter count; generate_batch at b8 with
   150-code prompts for 64 steps, wall and ms a token; a decode step's
   eager ms and device profile, and the device ms of the fixed
   2,048-position KV read beside its bound; teacher-forced logits (prefill and 16 steps) and KV caches of
   a copy built in f32 compute against the CPU within TOL_F32;
   weight_quant="int8" at b1 for 32 steps with its launch counts
   (int8_linear: qkv and the cross-attention's q, k and v; fused_ffn_int8:
   the 12 FFNs), every new int8 shape held; one f32 training forward and
   backward at b2 t128 against the CPU (loss, every parameter gradient
   within TOL_F32 of its own max, the softmax key-side biases masked) and
   one optimizer step; two bf16 train steps at b8 t512, timed;
   DecodeServer refusing the backbone (ValueError).
Each phase called from main prints its seconds, and main prints them all
before the summary.
Each main-path run starts with the launch counts at 0 and reads them right
after; every forward launch and every lazy step of a main path must have
taken its planned route. After the GLA phases, every shape a main path
launched the two forward kernels and gla_chunk's backward on is timed on the
route it took and on the recurrent body (where the backward's plan takes the
chunked route, that route must be the faster), every shape it launched the
lazy step on is held and timed (a float state on both routes in turns,
the planned one at most SWEEP_MARGIN slower by the median of six turns,
timed again before a miss fails; an int8 state on the tile route), every
shape it launched the two classic steps on is held on every route and
timed in turns (the planned route must be the faster), every shape it
folded a window on is held on every band height of the two folds (against
the plain version and the plain mirror of the kernels' bf16-part update)
and timed in turns (the planned band at most SWEEP_MARGIN slower), and
launches x (time - bound) is summed over those
launches; the summary ranks every kernel by it (the others at their row's
shape). The line before the last is a JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
from collections import Counter
import os
import re
import statistics
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
# the requests' max_len: SERVE_MAX_LEN + 16 (i % 5), at least 17 tokens past
# the longest prompt's 151 forced ones, short enough that every serving
# phase keeps the script well inside its time limit
SERVE_MAX_LEN = 168
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
# exponentials per second of the special-function units: 16 a clock on each
# SM, at the card's highest SM clock (set in main from nvidia-smi)
SFU_PER_CLOCK = 16
SFU_RATE = None
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
FFN_M = (1, 8, 64, 128)
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
    # the int4 bodies of the two kernels above: no TPU kernel of their own
    # (the JAX package's int4 step and fold are XLA, ops/gla.py:301 and :326)
    ("gla_decode_lazy_conv_int4", "lina_speech_tpu_torch/csrc/gla_decode_lazy_conv.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2197 (int4 state; JAX computes it in XLA, "
     "lina_speech_tpu/ops/gla.py:301)"),
    ("gla_fold_q_int4", "lina_speech_tpu_torch/csrc/gla_fold_q4.cu",
     "lina_speech_tpu/ops/gla_pallas.py:2097 (int4 state; JAX computes it in XLA, "
     "lina_speech_tpu/ops/gla.py:326)"),
    ("int8_linear", "lina_speech_tpu_torch/csrc/int8_linear.cu",
     "lina_speech_tpu/ops/qlinear.py:127"),
    ("fused_ffn_int8", "lina_speech_tpu_torch/csrc/fused_ffn_int8.cu",
     "lina_speech_tpu/ops/qlinear.py:241"),
    ("rwkv6_chunk", "lina_speech_tpu_torch/csrc/rwkv6_chunk.cu",
     "lina_speech_tpu/ops/rwkv6_pallas.py:565"),
    ("rwkv6_chunk_bwd", "lina_speech_tpu_torch/csrc/rwkv6_chunk_bwd.cu",
     "lina_speech_tpu/ops/rwkv6_pallas.py:137"),
    ("rwkv6_decode", "lina_speech_tpu_torch/csrc/rwkv6_decode.cu",
     "lina_speech_tpu/ops/gla_pallas.py:1728"),
    ("mamba_scan", "lina_speech_tpu_torch/csrc/mamba_scan.cu",
     "lina_speech_tpu/ops/mamba_pallas.py:468"),
    ("mamba_scan_bwd", "lina_speech_tpu_torch/csrc/mamba_scan_bwd.cu",
     "lina_speech_tpu/ops/mamba_pallas.py:86"))
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
# (b, h, t, dk, dv, IO dtype, initial-state dtype or None, scale, route) at
# which gla_chunk was held against its plain version; with need_ds0 in the
# route's place, the same for its backward. GLA_LAUNCHED gathers what the
# driven paths launched them and the two classic steps on
# (ops/gla_cuda.py:launch_shapes), and the last phase holds the rest.
CHUNK_HELD, CHUNK_BWD_HELD = set(), set()
# (b, h, dk, dv, IO dtype, state dtype, route) at which the two classic steps
# were held on that route against their plain versions (hold_decode_routes)
DECODE_HELD = {"gla_decode_conv": set(), "gla_decode": set()}
# launches of the two forward kernels, of gla_chunk's backward, of the
# four decode steps, of the two folds, of rwkv6_chunk and its backward and
# of the two Mamba kernels on each shape (the launch_shape_counts keys of ops/gla_cuda.py,
# ops/rwkv6_cuda.py and ops/mamba_cuda.py), summed over the main-path runs
# that expect_launches checks: the weights of gap_phase's (and its lazy,
# decode and fold phases'), rwkv6_gap_phase's and mamba_gap_phase's sums
GAP_SHAPE_COUNTS = {"gla_chunk_conv": Counter(), "gla_chunk": Counter(),
                    "gla_chunk_bwd": Counter(), "gla_decode_lazy_conv": Counter(),
                    "gla_fold": Counter(), "gla_fold_q": Counter(),
                    "gla_decode_conv": Counter(), "gla_decode": Counter(),
                    "rwkv6_chunk": Counter(), "rwkv6_chunk_bwd": Counter(),
                    "rwkv6_decode": Counter(),
                    "mamba_scan": Counter(), "mamba_scan_bwd": Counter()}
GLA_LAUNCHED = {"gla_chunk": set(), "gla_chunk_bwd": set(), "gla_decode_conv": set(),
                "gla_decode": set()}
# launches of the two int4 bodies on each shape (the launch_shape_counts keys
# with gla_cuda.INT4 as the state dtype), summed over the main-path runs
# that expect_launches checks, apart from GAP_SHAPE_COUNTS; and the shapes
# at which int4_kernel_phase held them against their plain versions
INT4_LAUNCHED = {"gla_decode_lazy_conv": Counter(), "gla_fold_q": Counter()}
INT4_HELD = {"gla_decode_lazy_conv": set(), "gla_fold_q": set()}
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
# Mamba (v1) at the flagship's width (kind="mamba": d 1024, 12 + 12 layers and
# the blind pos_net; each mixer d_inner 2048, d_state 16, d_conv 4, dt_rank
# 64; bf16 x, B, C; f32 dt, A, D and states), with A_log, D and dt_proj's bias
# drawn from seed 0 (models/mamba.py:perturb_mamba_params_); the interleaved
# CrossAttMamba with cross-attention after layers 5 and 11 of one stack of 12
MAMBA_D, MAMBA_N = 2048, 16
N_MAMBA_PARAMS, N_CROSSATT_MAMBA_PARAMS = 314_976_578, 174_774_944
VARIANT_TRAIN_STEPS["mamba"] = 3
# what the Mamba kernels were held against their plain versions at, and what
# the driven paths launched them on (ops/mamba_cuda.py:launch_shapes keys)
MAMBA_HELD = {"mamba_scan": set(), "mamba_scan_bwd": set()}
MAMBA_LAUNCHED = {"mamba_scan": set(), "mamba_scan_bwd": set()}


def reset_counts():
    from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda, qlinear, rwkv6_cuda

    gla_cuda.reset_launch_counts()
    qlinear.reset_launch_counts()
    rwkv6_cuda.reset_launch_counts()
    mamba_cuda.reset_launch_counts()


def read_counts() -> dict:
    """Every wrapper's launch count; the lazy step's launches on an int8
    state and on an int4 one, and the fold's on an int4 state, are counted a
    second time under a name of their own. Also notes,
    in Q_LAUNCHED, GLA_LAUNCHED, RWKV6_LAUNCHED and MAMBA_LAUNCHED, the
    shapes the int8 products, gla_chunk, its backward, gla_decode, the three
    RWKV6 kernels and the two Mamba kernels were launched on since the last
    reset."""
    from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda, qlinear, rwkv6_cuda

    for name, shapes in qlinear.launch_shapes().items():
        Q_LAUNCHED[name] |= shapes
    for name, shapes in gla_cuda.launch_shapes().items():
        if name in GLA_LAUNCHED:
            GLA_LAUNCHED[name] |= shapes
    for name, shapes in rwkv6_cuda.launch_shapes().items():
        RWKV6_LAUNCHED[name] |= shapes
    for name, shapes in mamba_cuda.launch_shapes().items():
        MAMBA_LAUNCHED[name] |= shapes
    return {**gla_cuda.launch_counts(), **qlinear.launch_counts(),
            **rwkv6_cuda.launch_counts(), **mamba_cuda.launch_counts(),
            "gla_decode_lazy_conv_int8": (gla_cuda.gla_decode_lazy_conv.q_launches
                                          - gla_cuda.gla_decode_lazy_conv.q4_launches),
            "gla_decode_lazy_conv_int4": gla_cuda.gla_decode_lazy_conv.q4_launches,
            "gla_fold_q_int4": gla_cuda.gla_fold_q.q4_launches}


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
              (("lazy_cluster_kernel",), "gla_decode_lazy_conv cluster"),
              (("lazy_tile_kernel",), "gla_decode_lazy_conv tile"),
              (("gla_decode_kernel", "Li256ELi1E"), "gla_decode_conv tile"),
              (("gla_decode_kernel", "Li256ELi0E"), "gla_decode tile"),
              (("gla_decode_kernel", "Li256ELi2E"), "rwkv6_decode tile"),
              (("gla_decode_wide_kernel", "Li256ELi1E"), "gla_decode_conv wide"),
              (("gla_decode_wide_kernel", "Li256ELi0E"), "gla_decode wide"),
              (("gla_decode_wide_kernel", "Li256ELi2E"), "rwkv6_decode wide"),
              (("gla_chunk_kernel", "Lb1E"), "gla_chunk_conv recurrent"),
              (("gla_chunk_kernel", "Lb0E"), "gla_chunk recurrent"))
    # the int8 products' instantiations the flagship launches (bf16 in and
    # out), by the m-tile each serves: {first template int: m-tile rows}
    products = ((("int8_linear_kernelI13__nv_bfloat16S", "Lb0ELb1E"),
                 "int8_linear mma wonly<bf16, bf16>", {2: 16, 4: 32}),
                (("int8_linear_kernelIa13__nv_bfloat16",), "int8_linear mma w8a8<bf16>",
                 {2: 16, 4: 32}),
                (("gemv_wonly_kernelI13__nv_bfloat16S",), "int8_linear gemv wonly<bf16, bf16>",
                 {1: 1, 8: 8}),
                (("gemv_w8a8_kernelI13__nv_bfloat16L",), "int8_linear gemv w8a8<bf16>",
                 {1: 1, 8: 8}),
                (("ffn_int8_kernelI13__nv_bfloat16S", "Lb1E"), "fused_ffn_int8<bf16, bf16>",
                 {1: 8, 2: 16}))
    # the int8 lazy-window kernels' bf16 instantiations (dv 512), and the lazy
    # step's cluster route on an f32 state
    quant = (("lazy_tile_kernelI13__nv_bfloat16aLi256E",
              "gla_decode_lazy_conv tile<bf16, int8, 256>"),
             ("lazy_cluster_kernelI13__nv_bfloat16fLi256E",
              "gla_decode_lazy_conv cluster<bf16, f32, 256>"))
    # the two folds' instantiations the flagship's b8 windows launch (bf16
    # IO; a bf16 state in 64-row bands, an int8 one of dv 512 in 32-row
    # bands: two sub-bands each)
    folds = (("gla_fold_band_kernelI13__nv_bfloat16S1_Li2ELi2EE",
              "gla_fold band<bf16, bf16, 2 sub-bands>"),
             ("gla_fold_q_band_kernelI13__nv_bfloat16Li8ELi2ELb0EE",
              "gla_fold_q band<bf16, dv 512, 2 sub-bands>"),
             ("gla_fold_q_band_kernelI13__nv_bfloat16Li8ELi2ELb1EE",
              "gla_fold_q band<bf16, dv 512, 2 sub-bands, int4>"))
    # the lazy step's int4 body (bf16 IO, dk 256): printed where found
    int4 = re.compile(r"lazy_tile_kernelI13__nv_bfloat16.*NibblesELi256E")
    # the RWKV6 kernels' bf16-IO, f32-state instantiations (dk 256; the
    # forward's recurrent body)
    rwkv6 = (("rwkv6_chunk_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk recurrent"),
             ("rwkv6_bwd_dr_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk_bwd dr sweep"),
             ("rwkv6_bwd_dkv_kernelI13__nv_bfloat16fLi256E", "rwkv6_chunk_bwd dk/dv sweep"),
             ("gla_decode_kernelI13__nv_bfloat16fLi256ELi2E", "rwkv6_decode tile"),
             ("gla_decode_wide_kernelI13__nv_bfloat16fLi256ELi2E", "rwkv6_decode wide"))
    # the Mamba kernels' bf16-IO instantiations
    mamba = (("11walk_kernelI13__nv_bfloat16Li3E", "mamba_scan walk with y"),
             ("11walk_kernelI13__nv_bfloat16Li2E", "mamba_scan chunk summaries"),
             ("11walk_kernelI13__nv_bfloat16Li1E", "mamba_scan_bwd chunk summaries"),
             ("11walk_kernelI13__nv_bfloat16Li0E", "mamba_scan_bwd checkpoint pass"),
             ("3bwd16chunk_bwd_kernelI13__nv_bfloat16E", "mamba_scan_bwd chunk body"))
    # the chunked route of the two GLA backwards (bf16 IO; both state dtypes)
    chunked = (("chunked11prep_kernelI13__nv_bfloat16Lb1EE", "gla_chunk_conv_bwd chunked prep"),
               ("chunked11prep_kernelI13__nv_bfloat16Lb0EE", "gla_chunk_bwd chunked prep"),
               ("chunked12state_kernelI13__nv_bfloat16E", "backward chunked states<bf16 state>"),
               ("chunked12state_kernelIfE", "backward chunked states<f32 state>"),
               ("chunked10dqk_kernel", "backward chunked dq/dk"),
               ("chunked9dv_kernelIfE", "gla_chunk_conv_bwd chunked dv"),
               ("chunked9dv_kernelI13__nv_bfloat16E", "gla_chunk_bwd chunked dv"),
               # the chunked route of the two forwards (bf16 IO)
               ("3gla11chunked_fwd11prep_kernelILb1EE", "gla_chunk_conv chunked prep"),
               ("3gla11chunked_fwd11prep_kernelILb0EE", "gla_chunk chunked prep"),
               ("3gla11chunked_fwd12state_kernelI13__nv_bfloat16EE",
                "forward chunked states<bf16 state>"),
               ("3gla11chunked_fwd12state_kernelIfEE", "forward chunked states<f32 state>"),
               ("3gla11chunked_fwd13scores_kernel", "forward chunked scores"),
               ("3gla11chunked_fwd10out_kernel", "forward chunked output"),
               # rwkv6_chunk's chunked route (bf16 IO)
               ("rwkv611chunked_fwd11prep_kernel", "rwkv6_chunk chunked prep"),
               ("rwkv611chunked_fwd12state_kernelI13__nv_bfloat16EE",
                "rwkv6_chunk chunked states<bf16 state>"),
               ("rwkv611chunked_fwd12state_kernelIfEE", "rwkv6_chunk chunked states<f32 state>"),
               ("rwkv611chunked_fwd13scores_kernel", "rwkv6_chunk chunked scores"),
               ("rwkv611chunked_fwd10out_kernel", "rwkv6_chunk chunked output"),
               # rwkv6_chunk_bwd's chunked route (bf16 IO)
               ("rwkv611chunked_bwd11prep_kernel", "rwkv6_chunk_bwd chunked prep"),
               ("rwkv611chunked_bwd12state_kernelI13__nv_bfloat16EE",
                "rwkv6_chunk_bwd chunked states<bf16 state>"),
               ("rwkv611chunked_bwd12state_kernelIfEE",
                "rwkv6_chunk_bwd chunked states<f32 state>"),
               ("rwkv611chunked_bwd10dqk_kernel", "rwkv6_chunk_bwd chunked dr/dk"),
               ("rwkv611chunked_bwd9dv_kernel", "rwkv6_chunk_bwd chunked dv"))
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
        for keys, label, tiles in products:
            first = re.search(r"Li(\d+)E", name)
            if all(key in name for key in keys) and first and int(first.group(1)) in tiles:
                out.append(f"{label} (m-tile {tiles[int(first.group(1))]}): {info}")
        for key, label in quant:
            if key in name and re.search(r"Li(16|256)E", name):
                out.append(f"{label}: {info}")
        out += [f"{label}<bf16, f32, 256>: {info}" for key, label in rwkv6 if key in name]
        out += [f"{label}<bf16>: {info}" for key, label in mamba if key in name]
        out += [f"{label}: {info}" for key, label in folds if key in name]
        out += [f"{label}: {info}" for key, label in chunked if key in name]
        if int4.search(name):
            out.append(f"gla_decode_lazy_conv tile<bf16, int4, 256>: {info}")
    for _, label in chunked:
        found = [line for line in out if line.startswith(f"{label}:")]
        require(any("registers" in line for line in found)
                and any("spill" in line for line in found),
                f"ptxas: no register or spill line of {label}")
    for label in [label for _, label in quant + folds] + [
            f"gla_decode_lazy_conv {r}<bf16, bf16, 256>" for r in LAZY_ROUTES] + [
            f"{kernel} {r}<bf16, bf16, 256>"
            for kernel in ("gla_decode_conv", "gla_decode", "rwkv6_decode")
            for r in ("tile", "wide")] + [
            f"rwkv6_decode {r}<bf16, f32, 256>" for r in ("tile", "wide")]:
        found = [line for line in out if line.startswith(f"{label}:")]
        require(any("registers" in line for line in found),
                f"ptxas: no register line of {label}")
    for _, label, tiles in products:  # a renamed kernel must not drop out in silence
        for tile in tiles.values():
            found = [line for line in out if line.startswith(f"{label} (m-tile {tile}):")]
            require(any("registers" in line for line in found)
                    and any("spill" in line for line in found),
                    f"ptxas: no register or spill line of {label} (m-tile {tile})")
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes, flops, io_dtype, exps=0):
    """(bound_ms, bound_by): the least time one H100 could take -- the
    bytes of every input read once and every output written once over the
    card's memory rate, or the function's operations over the card's peak
    rate for the inputs' type (bf16 and int8: tensor cores; f32: outside
    them), whichever is larger. ``exps``: exponentials the function takes
    beside (the Mamba scan's, one per state value), at the special-function
    units' rate (SFU_RATE); they count as operations."""
    import torch

    t_bytes = n_bytes / PEAK_BYTES
    peak = {torch.bfloat16: PEAK_BF16, torch.int8: PEAK_INT8}.get(io_dtype, PEAK_F32)
    t_ops = max(flops / peak, exps / SFU_RATE if exps else 0.0)
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

    from lina_speech_tpu_torch.ops.gla import dequantize_state_int4, unpack_state_int4

    worst, failed, ints = {}, [], None
    got_sc, ref_sc = ({place: t for field, place, t in state_leaves(st) if field == "s_scale"}
                      for st in (got, ref))
    v_width = {place: t.shape[-1] for field, place, t in state_leaves(ref) if field == "vbuf"}
    for (field, place, a), (_, _, r) in zip(state_leaves(got), state_leaves(ref)):
        require(a.shape == r.shape and a.dtype == r.dtype, f"{name}: {place} {field} differs "
                f"in shape or dtype: {tuple(a.shape)} {a.dtype} vs {tuple(r.shape)} {r.dtype}")
        if a.dtype == torch.int8 and 2 * a.shape[-1] == v_width.get(place):
            # an int4 state, two values a byte: by its nibbles, one step of
            # which is 1/7 of its row's largest value; dequantized within
            # that step beside ``rel``
            steps = (torch.cat(unpack_state_int4(a), -1).int()
                     - torch.cat(unpack_state_int4(r), -1).int()).abs()
            top, off = int(steps.max()), float((steps > 0).float().mean())
            far = float((steps > 1).float().mean())
            if not bool(r.any()):
                failed.append(f"{place} {field}: reference is all zeros")
            if far > 1e-2 or off > 0.5:
                failed.append(f"{place} {field}: int4 steps apart: max {top}, share off "
                              f"{off}, share more than one step off {far}")
            if ints is None or (top, off) > ints[:2]:
                ints = (top, off, far, place)
            a, r = dequantize_state_int4(a, got_sc[place]), dequantize_state_int4(r, ref_sc[place])
            err, ref_max = max_err(a, r), float(r.abs().max())
            if not err <= (rel + 1 / 7) * ref_max:
                failed.append(f"{place} s dequantized (int4): max_abs_err {err} > "
                              f"{(rel + 1 / 7) * ref_max}")
            if "s int4" not in worst or err / max(ref_max, 1e-30) > worst["s int4"][0]:
                worst["s int4"] = (err / max(ref_max, 1e-30), err, ref_max, place)
            continue
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
        print(f"  quantized s ({ints[3]}), the leaf furthest apart: at most {ints[0]} steps, "
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


def record(summary, name, err, ms, plain_ms, n_bytes, flops, io_dtype, library_ms=None,
           exps=0):
    """The kernel's row of the summary. ``library_ms`` stays None where no
    single PyTorch call computes the function (every GLA kernel)."""
    bound_ms, bound_by = roofline(n_bytes, flops, io_dtype, exps)
    print(f"  {name} bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} bytes, {flops} operations); kernel {ms:.6f} ms")
    summary[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)


def note_shape(name, shape, ms, plain_ms, n_bytes, flops, io_dtype, library_ms=None,
               exps=0):
    """A time at a further shape, with its bound; goes into the kernel's
    ``shapes`` list of the summary line."""
    bound_ms, bound_by = roofline(n_bytes, flops, io_dtype, exps)
    print(f"  {name} {shape}: kernel {ms:.6f} ms, plain {plain_ms if plain_ms is None else round(plain_ms, 6)} "
          f"ms, bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} bytes)"
          + (f", library {library_ms:.6f} ms" if library_ms is not None else ""))
    OTHER_SHAPES.setdefault(name, []).append(dict(
        shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms))


def fwd_args(x, conv):
    """The positional arguments of gla_chunk_conv (``conv``: xq, xk, xv, gk
    and the taps, from kernel_inputs) or of gla_chunk (q, k, v, gk, from
    qkv_inputs) in ``x``."""
    names = ("xq", "xk", "xv", "gk", "wq", "wk", "wv") if conv else ("q", "k", "v", "gk")
    return tuple(x[n] for n in names)


def fwd_fns(gla_cuda, conv):
    """(wrapper, plain version, the chunked route's plain version) of the
    conv-fused forward or of gla_chunk."""
    if conv:
        return (gla_cuda.gla_chunk_conv, gla_cuda.gla_chunk_conv_plain,
                gla_cuda.gla_chunk_conv_chunked_plain)
    return gla_cuda.gla_chunk, gla_cuda.gla_chunk_plain, gla_cuda.gla_chunk_chunked_plain


def fwd_on_route(gla_cuda, conv, args, s0, scale, route):
    """The forward (gla_chunk_conv with ``conv``, else gla_chunk) through the
    wrapper's launcher, forced onto ``route`` (the public wrappers take the
    plan's)."""
    launch = gla_cuda._chunk_conv_launch if conv else gla_cuda._chunk_launch
    return launch(*args, s0, args[0].shape[-1] ** -0.5 if scale is None else scale, route)


def hold_fwd_routes(torch, gla_cuda, conv, args, s0, scale, ref, tol_o, tol_s):
    """The forward (gla_chunk_conv with ``conv``, else gla_chunk) on each
    route its IO dtype has, under no_grad, against ``ref`` = (o, final
    state) of the plain version: o within ``tol_o`` and the state within
    ``tol_s`` of max(1, max|plain|), both finite; the chunked route also
    against its own plain version, the same decomposition with tensors,
    within the same shares. Returns {route: (o, final state)}."""
    chunked_plain = fwd_fns(gla_cuda, conv)[2]
    routes = ("recurrent", "chunked") if args[0].dtype == torch.bfloat16 else ("recurrent",)
    out = {}
    with torch.no_grad():
        for route in routes:
            o_k, s_k = out[route] = fwd_on_route(gla_cuda, conv, args, s0, scale, route)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(o_k).all()) and bool(torch.isfinite(s_k.float()).all()),
                    f"{route} route: output not finite")
            check(f"o, {route} route", max_err(o_k, ref[0]), bound(ref[0], tol_o))
            check(f"final state, {route} route", max_err(s_k, ref[1]), bound(ref[1], tol_s))
            if route == "chunked":
                o_c, s_c = chunked_plain(*args, initial_state=s0, scale=scale)
                check("o, chunked route vs its plain version", max_err(o_k, o_c),
                      bound(o_c, tol_o))
                check("final state, chunked route vs its plain version", max_err(s_k, s_c),
                      bound(s_c, tol_s))
    return out


# how much slower than the recurrent body the chunked route may read in the
# route sweep where the plan takes it: the sweep places the plan's
# thresholds, and a shape next to one may tie within the noise of 20 calls
# (the closest the sweep read, b2 gla_chunk dv512 t64, was 5% faster); at
# the main paths' shapes the chunked route must be the faster outright
SWEEP_MARGIN = 0.10


def time_fwd_routes(torch, gla_cuda, conv, args, s0, scale, label, work, iters=10, note=True):
    """Device ms of the forward's two routes on the same bf16 inputs, in
    turns (recurrent, chunked, chunked, recurrent). With ``note`` (a shape
    a main path launches) each goes into the kernel's further shapes beside
    the bound of ``work`` = (bytes, operations), and where
    gla_chunk_fwd_plan sends the shape to the chunked route that route must
    be the faster; without it (the route sweep) no more than SWEEP_MARGIN
    slower. Returns {route: mean ms}."""
    name = fwd_fns(gla_cuda, conv)[0].__name__
    b, h, t = args[0].shape[:3]
    times = {"recurrent": [], "chunked": []}
    with torch.no_grad():
        for route in ("recurrent", "chunked", "chunked", "recurrent"):
            times[route].append(device_ms(
                lambda: fwd_on_route(gla_cuda, conv, args, s0, scale, route), iters))
    ms = {route: sum(v) / len(v) for route, v in times.items()}
    planned = gla_cuda.gla_chunk_fwd_plan(args[0].dtype, b, h, t, args[2].shape[-1])
    print(f"  {name} {label} routes, device ms: recurrent {times['recurrent']}, chunked "
          f"{times['chunked']}; the plan takes {planned}")
    for route in ("chunked", "recurrent") if note else ():
        note_shape(name, f"{label}, {route} route", ms[route], None, *work, torch.bfloat16)
    if planned == "chunked":
        limit = ms["recurrent"] * (1 if note else 1 + SWEEP_MARGIN)
        require(ms["chunked"] < limit,
                f"{name} {label}: the plan takes the chunked route, but it is slower than "
                f"{limit} ms: {ms}")
    return ms


def expect_planned_routes():
    """Every launch of the two forward kernels since the last reset took the
    route gla_chunk_fwd_plan gives its shape (the flagship's conv-fused
    forward computes in bf16), every lazy step the route
    gla_decode_lazy_plan gives its, every classic step the route
    gla_decode_plan gives its, and each was counted under it."""
    import torch
    from lina_speech_tpu_torch.ops import gla_cuda

    shapes = gla_cuda.launch_shapes()
    for name, fn in (("gla_chunk_conv", gla_cuda.gla_chunk_conv),
                     ("gla_chunk", gla_cuda.gla_chunk)):
        require(sum(fn.routes.values()) == fn.launches,
                f"{name}: routes {fn.routes}, launches {fn.launches}")
        for shape in shapes[name]:
            if name == "gla_chunk_conv":
                (b, t), h, dv, io = shape[:2], H, DV, torch.bfloat16
            else:
                (b, h, t), dv, io = shape[:3], shape[4], shape[5]
            planned = gla_cuda.gla_chunk_fwd_plan(io, b, h, t, dv)
            require(shape[-1] == planned,
                    f"{name} launched on {shape}: the plan takes the {planned} route")
    lazy = gla_cuda.gla_decode_lazy_conv
    require(sum(lazy.routes.values()) == lazy.launches,
            f"gla_decode_lazy_conv: routes {lazy.routes}, launches {lazy.launches}")
    for b, h, dk, dv, io, st, L, p, route in shapes["gla_decode_lazy_conv"]:
        planned = gla_cuda.gla_decode_lazy_plan(b, h, st)
        require(route == planned, f"gla_decode_lazy_conv launched on b{b} h{h} {st} p{p}: the "
                f"plan takes the {planned} route")
    for fn in (gla_cuda.gla_decode_conv, gla_cuda.gla_decode):
        require(sum(fn.routes.values()) == fn.launches,
                f"{fn.__name__}: routes {fn.routes}, launches {fn.launches}")
        for b, h, dk, dv, io, st, route in shapes[fn.__name__]:
            planned = gla_cuda.gla_decode_plan(b, h, dk, dv, st)
            require(route == planned, f"{fn.__name__} launched on b{b} {head_name(h, dk, dv)} "
                    f"{st}: the plan takes the {planned} route")
    from lina_speech_tpu_torch.ops import rwkv6_cuda

    fn = rwkv6_cuda.rwkv6_chunk
    require(sum(fn.routes.values()) == fn.launches,
            f"rwkv6_chunk: routes {fn.routes}, launches {fn.launches}")
    for b, h, t, dk, dv, io, st, route in rwkv6_cuda.launch_shapes()["rwkv6_chunk"]:
        planned = rwkv6_cuda.rwkv6_chunk_fwd_plan(io, b, h, t, dv)
        require(route == planned, f"rwkv6_chunk launched on b{b} {head_name(h, dk, dv)} t{t} "
                f"{io}: the plan takes the {planned} route")
    dec = rwkv6_cuda.rwkv6_decode
    require(sum(dec.routes.values()) == dec.launches,
            f"rwkv6_decode: routes {dec.routes}, launches {dec.launches}")
    for b, h, dk, dv, io, st, route in rwkv6_cuda.launch_shapes()["rwkv6_decode"]:
        planned = rwkv6_cuda.rwkv6_decode_plan(b, h, dk, dv, st)
        require(route == planned, f"rwkv6_decode launched on b{b} {head_name(h, dk, dv)} {st}: "
                f"the plan takes the {planned} route")
    from lina_speech_tpu_torch.ops import mamba_cuda

    scan = mamba_cuda.mamba_scan
    require(sum(scan.routes.values()) == scan.launches,
            f"mamba_scan: routes {scan.routes}, launches {scan.launches}")
    for shape in mamba_cuda.launch_shapes()["mamba_scan"]:
        (b, t, d), chunk = shape[:3], shape[-1]
        planned = mamba_cuda.mamba_scan_plan(b, t, d)
        require(chunk == planned, f"mamba_scan launched on {shape}: the plan takes chunk length "
                f"{planned}")
    print(f"  forward routes as planned: gla_chunk_conv {gla_cuda.gla_chunk_conv.routes}, "
          f"gla_chunk {gla_cuda.gla_chunk.routes}, rwkv6_chunk {fn.routes}, mamba_scan "
          f"{scan.routes}; the lazy step "
          f"{lazy.routes}; the classic steps {gla_cuda.gla_decode_conv.routes}, "
          f"{gla_cuda.gla_decode.routes}, rwkv6_decode {dec.routes}")


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
            hold_fwd_routes(torch, gla_cuda, True, chunk_args, x["s0"], None, (o_p, s_p),
                            TOL_BF16, tol_s)
            if st == bf:
                time_fwd_routes(torch, gla_cuda, True, chunk_args, x["s0"], None, f"{tag} t{t}",
                                (nbytes(*chunk_args, x["s0"], o_k, s_k), scan_flops(b, t, True)))
            if b == 1 and st == bf:
                adv_args = chunk_args[:3] + (adversarial_gates(torch, x["gk"]),) + chunk_args[4:]
                print(f"gla_chunk_conv {tag} t{t}, adversarial gates:")
                hold_fwd_routes(torch, gla_cuda, True, adv_args, x["s0"], None,
                                gla_cuda.gla_chunk_conv_plain(*adv_args, initial_state=x["s0"]),
                                TOL_BF16, tol_s)
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
            hold_fwd_routes(torch, gla_cuda, True, chunk_args, x["s0"], None, (o_p, s_p),
                            TOL_BF16, tol_s)
            if st == bf:
                time_fwd_routes(torch, gla_cuda, True, chunk_args, x["s0"], None,
                                f"b1 state bfloat16 t{t}",
                                (nbytes(*chunk_args, x["s0"], o_k, s_k), scan_flops(1, t, True)))
            if st == bf and t in (128, 1):
                ms, plain_ms = timed_pair(
                    f"gla_chunk_conv b1 t{t}",
                    lambda: gla_cuda.gla_chunk_conv(*chunk_args, initial_state=x["s0"]),
                    lambda: gla_cuda.gla_chunk_conv_plain(*chunk_args, initial_state=x["s0"]),
                    10)
                note_shape("gla_chunk_conv", f"b1 state bfloat16 t{t}", ms, plain_ms,
                           nbytes(*chunk_args, x["s0"], o_k, s_k), scan_flops(1, t, True), bf)
    route_sweep(torch, gla_cuda)
    return summary


# lengths at which the forward's two routes are timed against each other,
# to place the plan's crossover (ops/gla_cuda.py:_FWD_CHUNKED_MIN_T)
SWEEP_T = (4, 16, 32, 48, 64, 96, 128)


def route_sweep(torch, gla_cuda):
    """Both forwards' two routes at b1, b2 and b8 over SWEEP_T (bf16 IO and
    state; the flagship's heads, and simple-GLA's dv 256 for gla_chunk):
    device ms of each, and where the plan takes the chunked route it may
    be no more than SWEEP_MARGIN slower."""
    bf = torch.bfloat16
    print("forward route sweep (device ms, recurrent vs chunked):")
    for conv, dv in ((True, DV), (False, DV), (False, SIMPLE_HEAD[2])):
        for b in (1, 2, BATCH):
            for t in SWEEP_T:
                if conv:
                    x = kernel_inputs(torch, b, t, bf, seed=600 + t)
                else:
                    x = qkv_inputs(torch, b, H, t, DK, dv, bf, bf, seed=600 + t)
                time_fwd_routes(torch, gla_cuda, conv, fwd_args(x, conv), x["s0"], None,
                                f"sweep b{b} dv{dv} t{t}", None, note=False)


def chunk_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk (post-conv q, k, v; non-zero initial state) vs its plain
    version at every length of CHUNK_T, t = 151 down to a single token, on
    both routes; the two routes' times at b1 t128, 64, 32 and 1 and at b8
    t151. The summary takes the serving prefill's largest chunk: b1, t128,
    bf16 state."""
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
                hold_fwd_routes(torch, gla_cuda, False, args, x["s0"], None, (o_p, s_p),
                                TOL_BF16, tol_s)
                CHUNK_HELD.update((b, H, t, DK, DV, bf, st, DK ** -0.5, route)
                                  for route in ("recurrent", "chunked"))
                if st == bf and (b, t) in ((1, 128), (1, 64), (1, 32), (1, 1), (8, 151)):
                    time_fwd_routes(torch, gla_cuda, False, args, x["s0"], None,
                                    f"b{b} state bfloat16 t{t}",
                                    (nbytes(*args, x["s0"], o_k, s_k), scan_flops(b, t, False)))
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
    b, h, dk = tok[0].shape
    dv = tok[2].shape[-1]
    moved = nbytes(*tok, *taps, *rings, state, s_scale, bufs[3], out[0], *out[1:4],
                   out[7]) + nbytes(*(t[:p + 1] for t in bufs[:3]))
    flops = b * h * (2 * dk * dv + (p + 1) * (3 * dk + 2 * dv) + 8 * (2 * dk + dv))
    return moved, flops


def hold_lazy_step(torch, out, ref, p, tol_o, own_max=False):
    """One lazy step of the kernel against its plain version: o finite and
    within ``tol_o`` of max(1, max|plain|) (``own_max``: of max|plain|, as
    hold_leaf); the rings, kbuf/vbuf/cbuf[:p+1] and cc equal to the plain
    version bit for bit. Returns o's error."""
    require(bool(torch.isfinite(out[0].float()).all()), "o is not finite")
    if own_max:
        err_o = hold_leaf("o", out[0], ref[0], tol_o)
    else:
        err_o = max_err(out[0], ref[0])
        check("o", err_o, bound(ref[0], tol_o))
    for name, a, r_ in zip(("ring q", "ring k", "ring v"), out[1:4], ref[1:4]):
        check(name, max_err(a, r_), 0.0)
    for name, a, r_ in zip(("kbuf", "vbuf", "cbuf"), out[4:7], ref[4:7]):
        check(f"{name}[:p+1]", max_err(a[:p + 1], r_[:p + 1]), 0.0)
    check("cc", max_err(out[7], ref[7]), 0.0)
    return err_o


def equal_bits_again(torch, call, first):
    """``call`` a second time on the same inputs gives the bits of ``first``
    (copied before the call: the window buffers are written in place)."""
    kept = [t.clone() for t in first]
    again = call()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(again, kept)),
            "a second call gave other bits")
    print("  a second call: equal bits")


def hold_other_lazy_route(torch, gla_cuda, tag, args, state, bufs, p, ref, states, work):
    """The lazy step over a float state at window position p on the route
    its plan does not take (``args``: tok, taps and rings), on copies of the
    window buffers: held against the plain version's step ``ref`` as
    hold_lazy_step does, equal bits on a second call, and timed on the cold
    states ``states`` hands out; a further shape of the row. Returns its
    ms."""
    b, h = args[0].shape[:2]
    planned = gla_cuda.gla_decode_lazy_plan(b, h, state.dtype)
    route = next(r for r in LAZY_ROUTES if r != planned)
    r_bufs = [t.clone() for t in bufs]
    call = lambda: lazy_on_route(gla_cuda, route, *args, state, *r_bufs, p)
    out = call()
    torch.cuda.synchronize()
    print(f"gla_decode_lazy_conv {tag} p{p}, {route} route (not planned here):")
    err = hold_lazy_step(torch, out, ref, p, TOL_BF16)
    equal_bits_again(torch, call, out)
    step = lambda: lazy_on_route(gla_cuda, route, *args, states(), *r_bufs, p)
    ms = (device_ms(step, 50) + device_ms(step, 50)) / 2
    note_shape("gla_decode_lazy_conv", f"{tag} p{p} {route} route", ms, None, *work,
               torch.bfloat16)
    return err


def lazy_kernel_phase(torch, gla_cuda, summary):
    """A whole lazy window at b1, b8 and b64: every step of
    gla_decode_lazy_conv against its plain version (slot p written in place,
    dead slots ignored, equal bits on a second call at p 0, 7 and 15, timed
    there on cold states), gla_fold against its plain version, and the
    window against 16 classic gla_decode_conv_plain steps (the lazy
    recurrence is the classic one)."""
    bf = torch.bfloat16
    for b in (1, 8, 64):
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
                before = [t.clone() for t in k_bufs]  # the buffers before the step
                if p in (0, 7, 15):  # time the step before taking it
                    scratch = [t.clone() for t in k_bufs]
                    timed[p] = timed_pair(
                        f"gla_decode_lazy_conv {tag} p{p}",
                        lambda: gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, states(),
                                                              *scratch, p),
                        lambda: gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *k_rings,
                                                                    states(), *scratch, p), 50)
                call = lambda: gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, s0, *k_bufs, p)
                out = call()
                ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, s0, *p_bufs, p)
                cls = gla_cuda.gla_decode_conv_plain(*tok, *taps, *c_rings, c_state)
                torch.cuda.synchronize()
                require([t.data_ptr() for t in out[4:7]] == ptrs,
                        "window buffers not written in place")
                if p in (0, 7, 15):
                    print(f"gla_decode_lazy_conv {tag} p{p}:")
                    err_o = hold_lazy_step(torch, out, ref, p, TOL_BF16)
                    check("o vs classic step", max_err(out[0], cls[0]), bound(cls[0], TOL_LOGITS))
                    equal_bits_again(torch, call, out)
                    moved, flops = lazy_step_work(tok, taps, k_rings, s0, None, k_bufs, out, p)
                    hold_other_lazy_route(torch, gla_cuda, tag, (*tok, *taps, *k_rings), s0,
                                          before, p, ref, states, (moved, flops))
                    if b == BATCH and p == WINDOW - 1 and st == bf:
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
            if st == bf and b != 1:
                classic_ms = device_ms(lambda: gla_cuda.gla_decode_conv(
                    *toks[-1], *taps, *rings, states()), 50)
                print(f"  classic gla_decode_conv step at {tag}, for comparison: device ms "
                      f"{classic_ms:.6f}")
                ms, plain_ms = timed_pair(
                    f"gla_fold {tag}", lambda: gla_cuda.gla_fold(states(), *k_bufs),
                    lambda: gla_cuda.gla_fold_plain(states(), *k_bufs), 50)
                fold_work = (nbytes(state, state, *k_bufs),
                             b * H * DK * (DV * (2 * WINDOW + 1) + 2 * WINDOW))
                if b == BATCH:
                    record(summary, "gla_fold", err_s, ms, plain_ms, *fold_work, bf)
                else:
                    note_shape("gla_fold", tag, ms, plain_ms, *fold_work, bf)


def lazy_case(torch, shape, seed):
    """One lazy step's inputs at ``shape`` = (b, h, dk, dv, IO dtype, state
    dtype, window L, p) as a main path gives them: slots j < p hold this
    window's tokens (cumsums above the running one), slots from p on stale
    garbage (cbuf 200); an int8 state comes with its row scales. Returns
    (tok, taps, rings, state, s_scale or None, bufs)."""
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    b, h, dk, dv, io, st, L, p = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    cums = (torch.nn.functional.logsigmoid(r(p + 1, b, h, dk)) / 16).cumsum(0)
    gate = cums[p] - cums[p - 1] if p else cums[0]
    tok = (r(b, h, dk).to(io), r(b, h, dk).to(io), r(b, h, dv).to(io), gate.contiguous())
    taps = [(r(4, h, d) * 0.5).to(io) for d in (dk, dk, dv)]
    rings = [r(4, b, h, d).to(io) for d in (dk, dk, dv)]
    cbuf = torch.full((L, b, h, dk), 200.0, device=DEVICE)
    cbuf[:p] = cums[:p]
    cc = cums[p - 1].clone() if p else torch.zeros(b, h, dk, device=DEVICE)
    bufs = [(r(L, b, h, dk) * 9).to(io), (r(L, b, h, dv) * 9).to(io), cbuf, cc]
    if st == torch.int8:
        state, s_scale = quantize_state_rows(r(b, h, dk, dv) * 0.05)
    else:
        state, s_scale = r(b, h, dk, dv).to(st), None
    return tok, taps, rings, state, s_scale, bufs


LAZY_ROUTES = ("cluster", "tile")
ROUTE_TURNS = 3  # rounds of (a, b, b, a) that time_routes takes
LAZY_SWEEP_B = (1, 2, 4, 6, 8, 16)  # batches of lazy_route_sweep (h4: 4 to 64 heads in flight)


def lazy_on_route(gla_cuda, route, *args, s_scale=None):
    """One lazy step on ``route`` (the wrapper's launcher, forced)."""
    return gla_cuda._lazy_launch(*args, s_scale=s_scale, route=route)


def time_routes(steps, turns=ROUTE_TURNS):
    """Device ms of each route's step in ``steps`` ({route: callable}):
    ``turns`` rounds of the routes in turns (a, b, b, a), 50 calls in a
    CUDA graph each time; returns ({route: median ms}, {route: every ms})."""
    order = list(steps)
    times = {r: [] for r in order}
    for _ in range(turns):
        for r in (*order, *reversed(order)):
            times[r].append(device_ms(steps[r], 50))
    return {r: statistics.median(v) for r, v in times.items()}, times


def planned_route_times(steps, route, label, strict=False):
    """time_routes for a shape the plan sends to ``route``: the planned
    route may be at most SWEEP_MARGIN slower than the fastest other (``strict``:
    must be the faster, as at the shapes a main path launched the classic
    step on). A shape that misses is timed again as many turns, and fails
    only if the median of both rounds misses too (one slow graph replay
    must not fail the run). Returns ({route: median ms}, {route: every
    ms})."""
    ms, times = time_routes(steps)
    other = min((r for r in steps if r != route), key=ms.get)
    ok = lambda m: m[route] < m[other] if strict else m[route] <= m[other] * (1 + SWEEP_MARGIN)
    if not ok(ms):
        print(f"  {label}: the planned {route} route read {ms[route]} ms against the {other} "
              f"route's {ms[other]} ms; timed again")
        _, more = time_routes(steps)
        times = {r: times[r] + more[r] for r in times}
        ms = {r: statistics.median(v) for r, v in times.items()}
        other = min((r for r in steps if r != route), key=ms.get)
    require(ok(ms), f"{label}: the planned {route} route {ms[route]} ms, the {other} route "
            f"{ms[other]} ms{' (it must be the faster)' if strict else ''} (turns, ms: {times})")
    return ms, times


def lazy_route_sweep(torch, gla_cuda, card_line):
    """Both routes of the lazy step timed in turns on cold float states at
    the flagship's head, b LAZY_SWEEP_B and p 0, 7 and 15, beside the route
    gla_decode_lazy_plan picks: where the plan's head-count threshold comes
    from. Prints only; the launched shapes are held to the plan in
    lazy_gap_phase."""
    print(f"gla_decode_lazy_conv route sweep (h{H} dk{DK} dv{DV}, bf16 IO, window {WINDOW}; "
          f"device us, median of {2 * ROUTE_TURNS} in turns) [{card_line}]:")
    for st in (torch.bfloat16, torch.float32):
        for b in LAZY_SWEEP_B:
            for p in (0, 7, 15):
                tok, taps, rings, state, _, bufs = lazy_case(
                    torch, (b, H, DK, DV, torch.bfloat16, st, WINDOW, p), seed=950 + b + p)
                rotation = cold_pool(state)
                steps = {r: (lambda r=r: lazy_on_route(gla_cuda, r, *tok, *taps, *rings,
                                                       rotation(), *bufs, p))
                         for r in LAZY_ROUTES}
                ms, _ = time_routes(steps)
                plan = gla_cuda.gla_decode_lazy_plan(b, H, st)
                print(f"  state {dtype_name(st)} b{b} ({b * H} heads) p{p}: tile "
                      f"{ms['tile'] * 1e3:.3f}, cluster {ms['cluster'] * 1e3:.3f}; planned {plan}, "
                      f"{'faster' if ms[plan] <= min(ms.values()) else 'slower'}")


def lazy_gap_phase(torch, gla_cuda, card_line):
    """Every shape a main path launched gla_decode_lazy_conv on
    (GAP_SHAPE_COUNTS) held against the plain version (o, the rings, the
    live window slots and cc, the buffers written in place, equal bits on a
    second call) and timed beside its bound on cold states: a float state
    on both routes in turns, where the planned route must be no more than
    SWEEP_MARGIN slower than the other (planned_route_times); an int8 state
    on the tile route, its only body. launches x (time - bound) summed over
    them, float and int8 states apart, on the routes taken and had every
    launch taken the tile route (the PR 3 / PR 5 body). Returns {row name:
    sum in ms on the routes taken}."""
    counts = GAP_SHAPE_COUNTS["gla_decode_lazy_conv"]
    sums = {name: {"taken": 0.0, "tile": 0.0}
            for name in ("gla_decode_lazy_conv", "gla_decode_lazy_conv_int8")}
    print(f"gla_decode_lazy_conv: launches x (time - bound) over {sum(counts.values())} "
          f"main-path launches on {len(counts)} shapes (device us):")
    for i, (shape, n) in enumerate(sorted(counts.items(), key=str)):
        b, h, dk, dv, io, st, L, p, route = shape
        require(route == gla_cuda.gla_decode_lazy_plan(b, h, st), f"{shape}: not the planned route")
        tok, taps, rings, state, s_scale, bufs = lazy_case(torch, shape[:8], seed=900 + i)
        tag = (f"b{b} {head_name(h, dk, dv)} IO {dtype_name(io)} state {dtype_name(st)} "
               f"L{L} p{p}")
        ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *rings, state, *bufs, p,
                                                  s_scale=s_scale)
        routes = ("tile",) if st == torch.int8 else LAZY_ROUTES
        steps = {}
        for r in routes:
            k_bufs = [t.clone() for t in bufs]
            ptrs = [t.data_ptr() for t in k_bufs[:3]]
            call = lambda: lazy_on_route(gla_cuda, r, *tok, *taps, *rings, state, *k_bufs, p,
                                         s_scale=s_scale)
            out = call()
            torch.cuda.synchronize()
            print(f"gla_decode_lazy_conv {tag}, {r} route:")
            require([t.data_ptr() for t in out[4:7]] == ptrs, "window buffers not written in place")
            hold_lazy_step(torch, out, ref, p, TOL_BF16 if io == torch.bfloat16 else TOL_F32,
                           own_max=st == torch.int8)
            equal_bits_again(torch, call, out)
            rotation = cold_rotation(state) if s_scale is None else cold_rotation(state, s_scale)

            def step(r=r, k_bufs=k_bufs, rotation=rotation):
                s, *sc = rotation()
                return lazy_on_route(gla_cuda, r, *tok, *taps, *rings, s, *k_bufs, p,
                                     s_scale=sc[0] if sc else None)

            steps[r] = step
        if len(steps) > 1:
            ms, times = planned_route_times(steps, route, f"{shape}")
        else:
            ms, times = time_routes(steps)
        bound_ms = roofline(*lazy_step_work(tok, taps, rings, state, s_scale, bufs, out, p),
                            io)[0]
        name = "gla_decode_lazy_conv_int8" if st == torch.int8 else "gla_decode_lazy_conv"
        sums[name]["taken"] += n * (ms[route] - bound_ms)
        sums[name]["tile"] += n * (ms["tile"] - bound_ms)
        print(f"  {n} launches; " + ", ".join(
            f"{r}{' (planned)' if r == route else ''} {ms[r] * 1e3:.3f}" for r in ms)
            + f", bound {bound_ms * 1e3:.3f} (medians; turns, ms: {times})")
    for name, total in sums.items():
        print(f"  {name}: sum of launches x (time - bound) {total['taken']:.3f} ms on the routes "
              f"taken; {total['tile']:.3f} ms had every launch taken the tile route (the PR 3 / "
              f"PR 5 body) [{card_line}]")
    return {name: total["taken"] for name, total in sums.items()}


# --------------------------------------------------------- classic decode
DECODE_SWEEP_B = (1, 2, 4, 6, 8, 16, 64)  # batches of decode_route_sweep
# (kernel, (h, dk, dv), IO dtype) of decode_route_sweep: the flagship's conv
# step, simple-GLA's and Mamba-2's steps without convs
DECODE_SWEEP_HEADS = (("gla_decode_conv", (H, DK, DV), "bfloat16"),
                      ("gla_decode", SIMPLE_HEAD, "bfloat16"),
                      ("gla_decode", MAMBA_HEAD, "float32"))


def decode_case(torch, name, shape, seed):
    """A classic step's inputs at ``shape`` = (b, h, dk, dv, IO dtype, state
    dtype) in the decode layouts: (the arguments but the state, the state).
    ``gla_decode_conv``: the pre-conv tokens, the gates, taps and rings;
    ``gla_decode``: q, k, v and the gates; ``rwkv6_decode``: r, k, v, the
    f32 log-decays and the bonus u (rwkv6_inputs' step 0)."""
    b, h, dk, dv, io, st = shape
    if name == "rwkv6_decode":
        x = rwkv6_inputs(torch, b, h, 1, dk, dv, io, st, seed)
        return (*(x[n][:, :, 0].contiguous() for n in ("r", "k", "v", "w")), x["u"]), x["s0"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    tok = (r(b, h, dk).to(io), r(b, h, dk).to(io), r(b, h, dv).to(io),
           torch.nn.functional.logsigmoid(r(b, h, dk)) / 16)
    state = r(b, h, dk, dv).to(st)
    if name == "gla_decode":
        return tok, state
    taps = [(r(4, h, d) * 0.5).to(io) for d in (dk, dk, dv)]
    rings = [r(4, b, h, d).to(io) for d in (dk, dk, dv)]
    return (*tok, *taps, *rings), state


def decode_fns(gla_cuda, name):
    """(public wrapper, plain version, split plain version or None, launcher
    that takes a route) of the classic step ``name``."""
    if name == "rwkv6_decode":
        from lina_speech_tpu_torch.ops import rwkv6_cuda

        return (rwkv6_cuda.rwkv6_decode, rwkv6_cuda.rwkv6_decode_plain, None,
                rwkv6_cuda._decode_launch)
    if name == "gla_decode_conv":
        return (gla_cuda.gla_decode_conv, gla_cuda.gla_decode_conv_plain,
                gla_cuda.gla_decode_conv_split_plain, gla_cuda._decode_conv_launch)
    return (gla_cuda.gla_decode, gla_cuda.gla_decode_plain, gla_cuda.gla_decode_split_plain,
            gla_cuda._decode_launch)


def decode_work(name, args, state, out):
    """(bytes, operations) of one classic step: the state read and written,
    every other input and output once; a decay, a rank-1 update and a
    readout of the state, and the three 4-tap convs where there are
    (rwkv6_flops for RWKV6's step)."""
    b, h, dk = args[0].shape
    dv = args[2].shape[-1]
    if name == "rwkv6_decode":
        return nbytes(*args, state, *out), rwkv6_flops(b, h, 1, dk, dv)
    convs = 8 * (2 * dk + dv) if name == "gla_decode_conv" else 0
    return nbytes(*args, state, *out), b * h * (5 * dk * dv + convs)


def decode_plan(gla_cuda, name, shape):
    """The route the classic step ``name``'s plan picks at ``shape`` = (b, h,
    dk, dv, IO dtype, state dtype): gla_decode_plan, or rwkv6_decode_plan
    (the same rule) for RWKV6's step."""
    b, h, dk, dv, _, st = shape
    if name == "rwkv6_decode":
        from lina_speech_tpu_torch.ops import rwkv6_cuda

        return rwkv6_cuda.rwkv6_decode_plan(b, h, dk, dv, st)
    return gla_cuda.gla_decode_plan(b, h, dk, dv, st)


def decode_pair(gla_cuda, name, shape):
    """(the route the plan picks at ``shape`` = (b, h, dk, dv, IO dtype,
    state dtype), the route it is timed against): the tile body against the
    wide route decode_wide_route would take, a wide route against the tile
    body."""
    b, h, dk, dv, _, st = shape
    planned = decode_plan(gla_cuda, name, shape)
    return planned, gla_cuda.decode_wide_route(b, h, dv, st) if planned == "tile" else "tile"


def decode_tag(name, shape):
    b, h, dk, dv, io, st = shape
    return f"{name} b{b} {head_name(h, dk, dv)} IO {dtype_name(io)} state {dtype_name(st)}"


def hold_decode_routes(torch, gla_cuda, name, shape, seed):
    """The classic step ``name`` at ``shape`` = (b, h, dk, dv, IO dtype,
    state dtype) on every route, forced, against its plain version, each
    GLA wide route also against its split plain version (its
    decomposition): o finite and within TOL_BF16 (bf16 IO; TOL_F32 in f32)
    of its own max|plain|, the state updated in place within TOL_BF16 (a
    bf16 IO or state; TOL_F32) of its own max|plain| (so not all zeros), the
    rings equal to the plain version's bit for bit, equal bits on a second
    call, and every route's state equal bit for bit (each rounds fma(e^g, S,
    k v) once). Notes the shape on every route in DECODE_HELD (RWKV6_HELD
    for rwkv6_decode). Returns ({route:
    a step on a rotation of cold states} for the planned route and the one
    it is timed against (decode_pair), the step's (bytes, operations))."""
    _, plain, split, launch = decode_fns(gla_cuda, name)
    args, s0 = decode_case(torch, name, shape, seed)
    ref = plain(*args, s0)
    tol = TOL_BF16 if shape[4] == torch.bfloat16 else TOL_F32
    tol_s = TOL_BF16 if torch.bfloat16 in shape[4:] else TOL_F32
    pair = decode_pair(gla_cuda, name, shape)
    held = RWKV6_HELD if name == "rwkv6_decode" else DECODE_HELD
    states = {}
    for route in gla_cuda._DECODE_ROUTE_CODE:
        s = s0.clone()
        out = launch(*args, s, route=route)
        again = launch(*args, s0.clone(), route=route)
        torch.cuda.synchronize()
        print(f"{decode_tag(name, shape)}, {route} route{' (planned)' if route == pair[0] else ''}:")
        require(out[1].data_ptr() == s.data_ptr(), "state not updated in place")
        require(bool(torch.isfinite(out[0].float()).all()), "o is not finite")
        hold_leaf("o", out[0], ref[0], tol)
        if route != "tile" and split is not None:
            hold_leaf("o vs split plain", out[0], split(*args, s0, route=route)[0], tol)
        hold_leaf("state", out[1], ref[1], tol_s)
        for ring, a, r_ in zip(("ring q", "ring k", "ring v"), out[2:], ref[2:]):
            check(ring, max_err(a, r_), 0.0)
        require(all(torch.equal(a, k) for a, k in zip(again, out)), "a second call gave other bits")
        states[route] = s
        held[name].add((*shape, route))
    require(all(torch.equal(s, states["tile"]) for s in states.values()),
            "the routes' states differ")
    print("  a second call: equal bits; every route's state: equal bits")
    rotation = cold_pool(s0)
    steps = {r: (lambda r=r: launch(*args, rotation(), route=r)) for r in pair}
    return steps, decode_work(name, args, s0, ref)


def decode_route_sweep(torch, gla_cuda, card_line):
    """The two classic steps' planned route and the one it is timed against
    (decode_pair: the tile body and the wide route the plan would take)
    timed in turns on cold states (medians of 2 ROUTE_TURNS) at the heads
    of DECODE_SWEEP_HEADS, b DECODE_SWEEP_B and f32 and bf16 states, beside
    the bound; the planned route may be no more than SWEEP_MARGIN slower
    (planned_route_times)."""
    print(f"classic decode route sweep (device us, median of {2 * ROUTE_TURNS} in turns; "
          f"tile / wide / bound) [{card_line}]:")
    for name, head, io_name in DECODE_SWEEP_HEADS:
        launch = decode_fns(gla_cuda, name)[3]
        for st in (torch.bfloat16, torch.float32):
            for b in DECODE_SWEEP_B:
                shape = (b, *head, getattr(torch, io_name), st)
                args, s0 = decode_case(torch, name, shape, seed=1000 + b)
                bound_ms = roofline(*decode_work(name, args, s0, launch(*args, s0.clone())),
                                    shape[4])[0]
                rotation = cold_pool(s0)
                plan, other = decode_pair(gla_cuda, name, shape)
                steps = {r: (lambda r=r: launch(*args, rotation(), route=r))
                         for r in (plan, other)}
                ms, _ = planned_route_times(steps, plan, decode_tag(name, shape))
                wide = plan if plan != "tile" else other
                print(f"  {decode_tag(name, shape)} ({b * head[0]} heads): "
                      f"{ms['tile'] * 1e3:.3f} / {ms[wide] * 1e3:.3f} ({wide}) / "
                      f"{bound_ms * 1e3:.3f}; planned {plan}, "
                      f"{'faster' if ms[plan] <= min(ms.values()) else 'slower'}")


def decode_gap_phase(torch, gla_cuda, card_line, names=("gla_decode_conv", "gla_decode")):
    """Every shape a main path launched the classic steps ``names`` on
    (GAP_SHAPE_COUNTS) held on every route (hold_decode_routes), the
    planned one and the one it is timed against (decode_pair) timed in
    turns on cold states beside its bound: the planned route must be the
    faster (planned_route_times, strict). launches x (time - bound) summed
    over them, on the routes taken and had every launch taken the tile
    route (the kernel's first body). Returns {kernel: sum in ms on the
    routes taken}."""
    sums = {}
    for name in names:
        counts = GAP_SHAPE_COUNTS[name]
        require(counts, f"{name}: the main paths launched it on no shape")
        total = {"taken": 0.0, "tile": 0.0}
        print(f"{name}: launches x (time - bound) over {sum(counts.values())} main-path launches "
              f"on {len(counts)} shapes (device us):")
        for i, (shape, n) in enumerate(sorted(counts.items(), key=str)):
            *dims, route = shape
            require(route == decode_plan(gla_cuda, name, tuple(dims)),
                    f"{name} {shape}: not the planned route")
            steps, work = hold_decode_routes(torch, gla_cuda, name, tuple(dims), seed=800 + i)
            ms, times = planned_route_times(steps, route, f"{name} {shape}", strict=True)
            bound_ms = roofline(*work, dims[4])[0]
            total["taken"] += n * (ms[route] - bound_ms)
            total["tile"] += n * (ms["tile"] - bound_ms)
            for r in ms:
                note_shape(name, f"{decode_tag(name, tuple(dims)).split(' ', 1)[1]}, {r} route"
                           f"{' (planned)' if r == route else ''}, {n} main-path launches, in "
                           "turns", ms[r], None, *work, dims[4])
            print(f"  {decode_tag(name, tuple(dims))}: {n} launches; " + ", ".join(
                f"{r}{' (planned)' if r == route else ''} {ms[r] * 1e3:.3f}" for r in ms)
                + f", bound {bound_ms * 1e3:.3f} (medians; turns, ms: {times})")
        print(f"  {name}: sum of launches x (time - bound) {total['taken']:.3f} ms on the routes "
              f"taken; {total['tile']:.3f} ms had every launch taken the tile route (the "
              f"kernel's first body) [{card_line}]")
        sums[name] = total["taken"]
    return sums


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
    expect_planned_routes()
    from lina_speech_tpu_torch.ops import gla_cuda, mamba_cuda, rwkv6_cuda

    for name, counts in {**gla_cuda.launch_shape_counts(), **rwkv6_cuda.launch_shape_counts(),
                         **mamba_cuda.launch_shape_counts()}.items():
        for shape, n in counts.items():
            if name in INT4_LAUNCHED and shape[5] == gla_cuda.INT4:
                INT4_LAUNCHED[name][shape] += n
            elif name in GAP_SHAPE_COUNTS:
                GAP_SHAPE_COUNTS[name][shape] += n


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
                         SERVE_MAX_LEN + 16 * (i % 5)))
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
    through 8 recycled slots in lazy mode, 8 in classic mode, each four
    decode chunks past its prompt (every slot busy, so that both modes are
    timed at 8 slots)."""
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    requests = serving_requests(np, cfg)
    total = dict.fromkeys(read_counts(), 0)
    tokens_by_mode = {}
    classic = [(text, prompt, (1 if prompt is None else 1 + prompt.shape[1]) + 4 * WINDOW)
               for text, prompt, _ in requests[:SERVE_CLASSIC_REQUESTS]]
    for lazy, reqs in ((True, requests), (False, classic)):
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
        n = min(c.length, len(ref_toks))
        same = float((c.tokens[:n] == ref_toks[:n]).mean())
        print(f"greedy token agreement, {mode} server vs generate_batch(lazy_window={WINDOW}) "
              f"at b1, request 0: {same:.4f} of {n} steps")

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
# the pipeline phase: the flagship and the 320_24k codec, from text to waveform
PIPE_TEXT = "the quick brown fox jumps over the lazy dog"
PIPE_PROMPT_SECONDS, PIPE_CODEC_SEED = 2, 11
PIPE_B1_SEQLEN = 100  # synthesize at b1 without a prompt: 99 decoded steps
# The codec on the card against the same module on the CPU, both f32 with
# TF32 off, each tensor to a share of its own max|ref| with no floor: the
# summation orders of cuDNN's and cuBLAS's f32 kernels differ from the CPU's
# by f32 rounding, and the waveform takes it through 4 + 12 blocks, the
# exponential of the magnitudes and the phases' cos and sin. An H100 read at
# most 3.9e-6 on the waveforms and 3.1e-6 on the latents; a decode with TF32
# on must miss it (the control in pipeline_phase).
TOL_CODEC = 1e-4
VOCODE_SHAPES = ((1, 750), (8, 200))  # (b, frames) timed: 10 s of speech; b8 x 200
ENCODE_SECONDS = 3


def vocoder_flops(cfg, b, frames) -> int:
    """Multiply-adds x 2 of ``codes_to_audio`` on (b, frames): the embed
    conv, the pos_net's convs, attention and projections, the ConvNeXt
    blocks, the head's Linear, and the inverse real FFT of each frame at
    the usual 2.5 n log2 n operations."""
    d, f = cfg.backbone_dim, cfg.backbone_intermediate_dim
    per_frame = (cfg.latent_dim * d * 7 + 4 * 2 * d * d * 3 + 4 * d * d + 2 * d * frames
                 + cfg.backbone_layers * (d * 7 + 2 * d * f) + d * (cfg.n_fft + 2))
    irfft = 2.5 * cfg.n_fft * math.log2(cfg.n_fft)
    return int(b * frames * (2 * per_frame + irfft))


def hold_codes(card_codes, cpu_codes, card_latents, cpu_latents, codebook):
    """Codes of the card equal the CPU's, except where the CPU's score of
    its own pick and of the card's are closer than the latents' difference
    can move them: |2 (x' - x).(e_cpu - e_card)| <= 2 |x' - x| |e_cpu - e_card|,
    plus the f32 rounding of the scores themselves."""
    diff = (card_codes.cpu() != cpu_codes).nonzero().tolist()
    worst = 0.0
    e = codebook.detach().double()
    for q, b, t in diff:
        x, x_card = cpu_latents[b, t].double(), card_latents[b, t].cpu().double()
        e_cpu, e_card = e[cpu_codes[q, b, t]], e[card_codes[q, b, t]]
        score = lambda v: 2.0 * x @ v - v @ v
        gap = float(score(e_cpu) - score(e_card))
        room = 2.0 * float((x_card - x).norm() * (e_cpu - e_card).norm()) \
            + 1e-5 * max(1.0, abs(float(score(e_cpu))))
        worst = max(worst, gap / room)
        require(gap <= room, f"code ({q}, {b}, {t}): the CPU's pick leads the card's by {gap}, "
                             f"more than the latents' difference allows ({room})")
    print(f"  codes: {card_codes.numel() - len(diff)} of {card_codes.numel()} equal; "
          f"{len(diff)} near-ties, worst gap / allowed {worst:.3f}")


def drain(gen):
    """The items a generator yields, and the value it returns."""
    items = []
    while True:
        try:
            items.append(next(gen))
        except StopIteration as stop:
            return items, stop.value


def pipeline_phase(torch, np, model, cfg, card_line):
    """TTSPipeline at full width: the flagship (the generate phase's model)
    and WavTokenizerConfig() (random weights, f32). (a) a prompt encoded on
    the card and on the CPU; (b) synthesize at b8 with those prompts and at
    b1 without one, launch counts checked, wall ms and seconds of speech a
    second; (c) the card's vocoder against the CPU's on (b)'s codes, and a
    TF32 control that must miss TOL_CODEC; (d) stream_synthesize through a
    one-slot server against vocode_streaming on the final codes it returns;
    (e) device ms of the vocoder and the encoder. Each step prints its
    seconds. Returns the launch counts of (b) and (d)."""
    import copy

    from lina_speech_tpu_torch.codec.vq import vq_encode
    from lina_speech_tpu_torch.codec.wavtokenizer import (
        WavTokenizerConfig, build_wavtokenizer, vocode_streaming)
    from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
    from lina_speech_tpu_torch.generate import cut_outputs
    from lina_speech_tpu_torch.pipeline import TTSPipeline, undelay_stream
    from lina_speech_tpu_torch.serving import _pow2_chunks

    started = time.perf_counter()
    last = [started]

    def step_took(step):
        now = time.perf_counter()
        print(f"  ({step}) took {now - last[0]:.1f} s")
        last[0] = now

    wcfg = WavTokenizerConfig()
    wavtok = build_wavtokenizer(wcfg, seed=PIPE_CODEC_SEED)
    cpu_codec = copy.deepcopy(wavtok).cpu()
    n_params = sum(p.numel() for p in wavtok.parameters())
    print(f"pipeline phase: lina_gla_169m and WavTokenizerConfig() ({n_params:,} parameters, "
          f"hop {wcfg.hop_length}, {wcfg.bins} bins, f32) on {wavtok.device}")
    pipe = TTSPipeline(model, wavtok, TextTokenizer())
    hop, rate = wcfg.hop_length, wcfg.sample_rate
    total = dict.fromkeys(read_counts(), 0)

    # (a) a prompt: 2 s of seeded noise at 24 kHz, b8 -> 150 frames
    rng = np.random.default_rng(PIPE_CODEC_SEED)
    audio = (0.1 * rng.normal(size=(BATCH, PIPE_PROMPT_SECONDS * rate))).astype(np.float32)
    prompt = pipe.tokenize_audio(audio)
    frames = PIPE_PROMPT_SECONDS * rate // hop
    require(tuple(prompt.shape) == (1, BATCH, frames), f"prompt codes {tuple(prompt.shape)}")
    with torch.no_grad():
        card_latents = wavtok.encoder(torch.from_numpy(audio).to(DEVICE))
        cpu_latents = cpu_codec.encoder(torch.from_numpy(audio))
        cpu_codes = vq_encode(cpu_latents, cpu_codec.quantizer, wcfg.n_q)
    print(f"(a) tokenize_audio: b{BATCH} x {PIPE_PROMPT_SECONDS} s -> codes {tuple(prompt.shape)}; "
          f"card vs CPU (f32):")
    check("latents", max_err(card_latents.cpu(), cpu_latents),
          TOL_CODEC * float(cpu_latents.abs().max()))
    hold_codes(prompt, cpu_codes, card_latents, cpu_latents,
               cpu_codec.quantizer.embed[0])
    step_took("a")

    # (b) synthesize: b8 with the prompts, b1 without one. The wall is the
    # first run's: every row's length is new to the codec, as a server's are.
    runs = {}
    for b, codes, seqlen in ((BATCH, prompt, MAX_SEQLEN), (1, None, PIPE_B1_SEQLEN)):
        gen = torch.Generator(device=DEVICE).manual_seed(b)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        waves, res = pipe.synthesize(PIPE_TEXT, gen, batch_size=b, prompt_codes=codes,
                                     max_seqlen=seqlen)
        wall = time.perf_counter() - t0
        launches = read_counts()
        n_pre = 1 + (0 if codes is None else frames)
        what = "no prompt" if codes is None else f"{frames}-frame prompts"
        speech = sum(w.size for w in waves) / rate
        print(f"(b) synthesize b{b} ({what}, max_seqlen {seqlen}): {res.n_steps} steps, "
              f"{wall * 1e3:.1f} ms wall, {speech:.3f} s of speech, {speech / wall:.3f} s of "
              f"speech a second [{card_line}]")
        print(f"  launches: {launches}")
        expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                        gla_decode_conv=N_GLA_LAYERS * (res.n_steps - n_pre))
        add_launches(total, launches)
        cut = [c for c, _ in cut_outputs(res, cfg.n_quant)]
        for i, (wav, c) in enumerate(zip(waves, cut)):
            n = c.shape[-1]
            require(n > 0 and wav.shape == (n * hop,), f"row {i}: {wav.shape} for {n} frames")
            require(bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
                    f"row {i}: waveform not finite or all zero")
        print(f"  frames per row {[c.shape[-1] for c in cut]}; every waveform finite, non-zero, "
              f"frames x {hop} long")
        # the same rows vocoded again alone, at lengths the codec has now seen
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for c in cut:
                wavtok.codes_to_audio(torch.from_numpy(c).to(DEVICE))[0].cpu()
        vocode = time.perf_counter() - t0
        decoded = res.n_steps - n_pre
        print(f"  vocoding its {b} rows again one by one: {vocode * 1e3:.1f} ms; the rest "
              f"(text, generate_batch, the cut, the codec's first calls at these lengths) "
              f"{(wall - vocode) * 1e3:.1f} ms, {(wall - vocode) * 1e3 / max(decoded, 1):.2f} ms "
              f"a decoded step ({decoded})")
        runs[b] = (waves, cut)
    step_took("b")

    # (c) the card's vocoder against the CPU's on (b)'s codes; row 0 of b8
    # also by its backbone output, and decoded once more with TF32 on as a
    # control the tolerance must catch
    print("(c) codes_to_audio on (b)'s codes, card vs CPU (f32, each tensor to its own max|ref|):")
    worst, n_rows = 0.0, 0
    for b, (waves, cut) in runs.items():
        for i, c in enumerate(cut):
            with torch.no_grad():
                feats_ref = cpu_codec.backbone(cpu_codec.codes_to_features(torch.from_numpy(c)))
                ref = cpu_codec.head(feats_ref)[0].numpy()
            err = float(np.abs(waves[i] - ref).max())
            scale = float(np.abs(ref).max())
            worst, n_rows = max(worst, err / scale), n_rows + 1
            require(err <= TOL_CODEC * scale,
                    f"b{b} row {i}: waveform {err} > {TOL_CODEC} x {scale}")
            if (b, i) == (BATCH, 0):
                codes0, ref0, scale0, feats_ref0 = torch.from_numpy(c).to(DEVICE), ref, scale, \
                    feats_ref
    with torch.no_grad():
        feats = wavtok.backbone(wavtok.codes_to_features(codes0))
    check("b8 row 0 backbone output", max_err(feats.cpu(), feats_ref0),
          TOL_CODEC * float(feats_ref0.abs().max()))
    print(f"  waveforms of {n_rows} rows: worst max_abs_err / max|ref| {worst:.3e} "
          f"(tolerance {TOL_CODEC:.0e})")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        tf32 = wavtok.codes_to_audio(codes0)[0].cpu().numpy()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    miss = float(np.abs(tf32 - ref0).max()) / scale0
    print(f"  control: b8 row 0 decoded on the card with TF32 on: {miss:.3e} of max|ref| "
          f"(must exceed the tolerance {TOL_CODEC:.0e})")
    require(miss > TOL_CODEC, f"TOL_CODEC {TOL_CODEC} passes a TF32 decode ({miss})")
    step_took("c")

    # (d) streaming through a one-slot server, against vocode_streaming on
    # the final codes of that run
    prompt0 = prompt[:, 0].cpu().numpy()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    chunks, done = drain(pipe.stream_synthesize(PIPE_TEXT, max_seqlen=MAX_SEQLEN,
                                                prompt_codes=prompt0))
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_forced = 1 + prompt0.shape[1]
    n_chunks = max(0, -(-(done.length - n_forced) // 16))
    print(f"(d) stream_synthesize (one slot, window 60, context 64, chunk 16): {len(chunks)} "
          f"chunks, {wall * 1e3:.1f} ms wall [{card_line}]; launches {launches}")
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_chunk=N_GLA_LAYERS * (len(_pow2_chunks(n_forced)) - 1),
                    gla_decode_conv=N_GLA_LAYERS * 16 * n_chunks)
    add_launches(total, launches)
    final = undelay_stream(done.tokens, cfg.n_quant, stopped=done.stopped)
    want = torch.cat(list(vocode_streaming(wavtok, torch.from_numpy(final)[:, None].to(DEVICE))),
                     dim=-1).cpu().numpy()
    stream = np.concatenate(chunks, axis=-1)
    require(stream.shape == want.shape == (1, final.shape[1] * hop),
            f"stream {stream.shape}, vocode_streaming {want.shape}")
    require(np.array_equal(stream, want),
            f"stream differs from vocode_streaming by {np.abs(stream - want).max()}")
    print(f"  {final.shape[1]} frames: the chunks equal vocode_streaming on the final codes")
    step_took("d")

    # (e) device times
    print(f"(e) times [{card_line}]:")
    with torch.no_grad():
        for b, n in VOCODE_SHAPES:
            codes = torch.from_numpy(rng.integers(0, wcfg.bins, size=(1, b, n))).to(DEVICE)
            ms = device_ms(lambda: wavtok.codes_to_audio(codes), 10)
            eager = eager_ms(lambda: wavtok.codes_to_audio(codes), 10)
            flops = vocoder_flops(wcfg, b, n)
            print(f"  vocoder codes_to_audio b{b} x {n} frames ({b * n * hop / rate:.2f} s of "
                  f"speech): device {ms:.3f} ms (CUDA graph), eager {eager:.3f} ms; "
                  f"{flops / 1e9:.1f} GFLOP, bound {flops / PEAK_F32 * 1e3:.3f} ms by f32 operations, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s [{card_line}]")
        codes = torch.from_numpy(rng.integers(0, wcfg.bins, size=(1, 1, 750))).to(DEVICE)
        profiled(torch, lambda: [wavtok.codes_to_audio(codes) for _ in range(3)],
                 "codes_to_audio b1 x 750 frames, 3 calls", top=10)
        x = torch.from_numpy(rng.normal(size=(1, ENCODE_SECONDS * rate)).astype(np.float32) * 0.1)
        x = x.to(DEVICE)
        ms = device_ms(lambda: wavtok.encode(x), 10)
        eager = eager_ms(lambda: wavtok.encode(x), 10)
        print(f"  encoder encode b1 x {ENCODE_SECONDS} s: device {ms:.3f} ms (CUDA graph), "
              f"eager {eager:.3f} ms [{card_line}]")
    step_took("e")
    print(f"pipeline phase took {time.perf_counter() - started:.1f} s")
    del wavtok, cpu_codec
    torch.cuda.empty_cache()
    return total


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
    again = qlinear.int8_linear(x, q, s, out_dtype=odt, mode=mode)
    ref = qlinear.int8_linear_plain(x, q, s, out_dtype=odt, mode=mode)
    torch.cuda.synchronize()
    require(out.shape == (m, n) and out.dtype == odt, "int8_linear output shape or dtype")
    tag = (f"{mode} m{m} K{k} N{n} {str(xdt).split('.')[-1]}->{str(odt).split('.')[-1]}")
    require(torch.equal(out, again), f"int8_linear {tag} differs from run to run")
    # w8a8: an exact int32 sum and the same two scale multiplications
    require(mode == "wonly" or torch.equal(out, ref), f"int8_linear {tag} differs from the "
            "plain version's bits")
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
    q_out, s_out, _, w_out = quantized_weight(torch, d, hidden, seed=d + 2)
    g = torch.Generator(device=DEVICE).manual_seed(m)
    x = torch.randn(m, d, generator=g, device=DEVICE).to(xdt)
    b_in = (torch.randn(2 * hidden, generator=g, device=DEVICE) * 0.02).to(torch.bfloat16)
    b_out = (torch.randn(d, generator=g, device=DEVICE) * 0.02).to(torch.bfloat16)
    call = lambda fn, qi, qo: fn(x, qi, s_in, b_in, qo, s_out, b_out, out_dtype=odt)
    out = call(qlinear.fused_ffn_int8, q_in, q_out)
    again = call(qlinear.fused_ffn_int8, q_in, q_out)
    ref = call(qlinear.fused_ffn_int8_plain, q_in, q_out)
    torch.cuda.synchronize()
    require(out.shape == (m, d) and out.dtype == odt, "fused_ffn_int8 output shape or dtype")
    require(torch.equal(out, again), "fused_ffn_int8 differs from run to run")
    tag = f"m{m} d{d} hidden{hidden} {str(xdt).split('.')[-1]}->{str(odt).split('.')[-1]}"
    err = hold_leaf(f"fused_ffn_int8 {tag}", out, ref, TOL_Q)
    Q_HELD["fused_ffn_int8"].add(shape)
    if not timed:
        return
    weights, dense = cold_rotation(q_in, q_out), cold_rotation(w_in, w_out)
    ms, plain_ms = timed_pair(
        f"fused_ffn_int8 {tag}", lambda: call(qlinear.fused_ffn_int8, *weights()),
        lambda: call(qlinear.fused_ffn_int8_plain, *weights()), 50)
    xb = x.to(torch.bfloat16)

    def library():
        wi, wo = dense()
        gate, h = F.linear(xb, wi, b_in).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * h, wo, b_out)

    library_ms = device_ms(library, 50)
    work = (nbytes(x, q_in, s_in, b_in, q_out, s_out, b_out, out), 6 * m * d * hidden,
            torch.bfloat16)
    if summary is not None:
        record(summary, "fused_ffn_int8", err, ms, plain_ms, *work, library_ms=library_ms)
        print(f"  library (two F.linear on bf16 weights and the activation): "
              f"{library_ms:.6f} ms")
    else:
        note_shape("fused_ffn_int8", tag, ms, plain_ms, *work, library_ms=library_ms)


def quant_linear_kernel_phase(torch, summary):
    """int8_linear at m 1, 8, 64 and 128 for every (K, N) of QLINEAR_KN in
    both modes (m 1 and 8 take the GEMV body, 64 and 128 the tensor-core
    body: ops/qlinear.py:int8_linear_plan), fused_ffn_int8 at m 1, 8, 64 and
    128, bf16 in and out as the flagship runs them, all timed (w8a8 at one
    (K, N)); the tensor-core body's 16-row tile and f32 activations held.
    The summary's rows: the b1 decode shapes, m 1."""
    bf = torch.bfloat16
    for k, n in QLINEAR_KN:
        for mode in ("wonly", "w8a8"):
            for m in QLINEAR_M:
                timed = mode == "wonly" or (k, n) == (1024, 2048)
                main = (m, k, n, mode) == (1, 1024, 2048, "wonly")
                hold_int8_linear(torch, (m, k, n, mode, bf, bf), summary if main else None, timed)
    # the tensor-core body's 16-row m-tile (a 16-row prefill chunk)
    for mode in ("wonly", "w8a8"):
        hold_int8_linear(torch, (16, 1024, 2048, mode, bf, bf))
    # f32 activations reach the kernel too (an f32 compute dtype)
    hold_int8_linear(torch, (3, FFN_HIDDEN, 1024, "wonly", torch.float32, torch.float32))
    hold_int8_linear(torch, (67, FFN_HIDDEN, 1024, "wonly", torch.float32, bf))
    hold_int8_linear(torch, (3, FFN_HIDDEN, 1024, "w8a8", torch.float32, bf))
    for m in FFN_M:
        hold_fused_ffn(torch, (m, D_MODEL, FFN_HIDDEN, bf, bf), summary if m == 1 else None, True)
    hold_fused_ffn(torch, (5, D_MODEL, FFN_HIDDEN, torch.float32, torch.float32))


def quant_lazy_kernel_phase(torch, gla_cuda, summary):
    """A whole lazy window over an int8 base state at b1, b8 and b64: every
    step of gla_decode_lazy_conv with ``s_scale`` against its plain version
    (equal bits on a second call at p 0, 7 and 15, timed there on a
    rotation of cold states; the tile route, the only one that takes an
    int8 state, and the cluster route refused), then gla_fold_q against
    its plain version:
    the new int8 state by integers (at most one step apart, and how many
    differ), the new scales, and the dequantized product; updated in
    place."""
    from lina_speech_tpu_torch.ops.gla import dequantize_state_rows, quantize_state_rows

    bf = torch.bfloat16
    for b in (1, 8, 64):
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
            call = lambda: gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, state_q, *k_bufs,
                                                         p, s_scale=s_scale)
            out = call()
            ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, state_q, *p_bufs, p,
                                                      s_scale=s_scale)
            torch.cuda.synchronize()
            require([t.data_ptr() for t in out[4:7]] == ptrs, "window buffers not written in place")
            if p in (0, 7, 15):
                print(f"gla_decode_lazy_conv {tag} p{p}:")
                err_o = hold_lazy_step(torch, out, ref, p, TOL_BF16, own_max=True)
                equal_bits_again(torch, call, out)
                work = lazy_step_work(tok, taps, k_rings, state_q, s_scale, k_bufs, out, p)
                try:
                    lazy_on_route(gla_cuda, "cluster", *tok, *taps, *k_rings, state_q,
                                  *[t.clone() for t in k_bufs], p, s_scale=s_scale)
                except ValueError as e:
                    print(f"  the cluster route refuses an int8 state: {e}")
                else:
                    require(False, "the cluster route took an int8 state")
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

    # classic loop on int8 weights at b8: prefill at full precision
    for b in (BATCH,):
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

            cases = [(BATCH, False, False), (BATCH, True, False), (BATCH, False, True),
                     (BATCH, True, True)]
            times = {case: [] for case in cases}
            for case in cases:
                steps_ms(*case)  # warm
            for case in cases:
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
        ("int8_linear", ("int8_linear_kernel", "gemv_", "quantize_rows_kernel")),
        ("fused_ffn_int8", ("ffn_int8_kernel",)),
        ("GLA kernels", ("gla_",))))


def quant_serving_phase(torch, np, model, cfg, card_line):
    """DecodeServer on int8 weights and int8 lazy-window states: 12 requests
    (each two decode chunks past its prompt) through 8 recycled slots with
    prefill at full precision, then 4 requests
    through a server that keeps only the int8 weights (prefill and text
    encoding through the int8 route). The second server takes the float
    weights out of ``model``: nothing else may use it afterwards."""
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    requests = serving_requests(np, cfg)
    total = dict.fromkeys(read_counts(), 0)
    quant = dict(lazy=True, k=1, state_quant="int8", weight_quant="int8")
    short = [(text, prompt, (1 if prompt is None else 1 + prompt.shape[1]) + 2 * WINDOW)
             for text, prompt, _ in requests]
    for full_precision, reqs in ((True, short), (False, short[:len(SERVE_PROMPTS)])):
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


# ------------------------------------------------------------- int4 states
INT4_BATCHES = (1, 8, 64)  # int4_kernel_phase's windows
INT4_SERVE_MAX_LEN = T_PROMPT + 1 + 2 * WINDOW  # two decode chunks a request


def int4_window_check(torch, gla_cuda, b, summary=None):
    """A whole lazy window over an int4 state (two values a byte) at batch
    ``b``: every step of gla_decode_lazy_conv on it against its plain
    version (o within TOL_BF16 of its own max|plain|, the rings, live slots
    and cc equal; slot p written in place; at p 0, 7 and 15 equal bits on a
    second call and the time on a rotation of cold states; the cluster
    route refused), then gla_fold_q on it against its plain version and its
    plain mirror of the kernel's bf16-part update: nibbles at most one step
    apart in at most 1e-3 of them, scales to 1e-5, updated in place, and
    timed. With ``summary`` the b8 times are the rows of the summary line,
    the others further shapes."""
    from lina_speech_tpu_torch.ops.gla import (
        dequantize_state_int4, quantize_state_rows_int4, unpack_state_int4,
    )

    bf = torch.bfloat16
    tag = f"b{b} state int4"
    toks, taps, rings, s_float, bufs = lazy_inputs(torch, b, torch.float32, seed=b + 31)
    state_q, s_scale = quantize_state_rows_int4(s_float * 0.05)
    require(state_q.shape == (b, H, DK, DV // 2) and bool(state_q.any())
            and float(s_scale.min()) > 0, "an empty int4 state")
    k_rings = p_rings = rings
    k_bufs, p_bufs = [t.clone() for t in bufs], [t.clone() for t in bufs]
    states = cold_rotation(state_q, s_scale)

    def step(fn, bufs_, p, tok):
        q, sc = states()
        return fn(*tok, *taps, *k_rings, q, *bufs_, p, s_scale=sc)

    for p, tok in enumerate(toks):
        ptrs = [t.data_ptr() for t in k_bufs[:3]]
        timed = None
        if summary is not None and p in (0, 7, 15):  # time the step before taking it
            scratch = [t.clone() for t in k_bufs]
            timed = timed_pair(f"gla_decode_lazy_conv {tag} p{p}",
                               lambda: step(gla_cuda.gla_decode_lazy_conv, scratch, p, tok),
                               lambda: step(gla_cuda.gla_decode_lazy_conv_plain, scratch, p, tok),
                               50)
        call = lambda: gla_cuda.gla_decode_lazy_conv(*tok, *taps, *k_rings, state_q, *k_bufs, p,
                                                     s_scale=s_scale)
        out = call()
        ref = gla_cuda.gla_decode_lazy_conv_plain(*tok, *taps, *p_rings, state_q, *p_bufs, p,
                                                  s_scale=s_scale)
        torch.cuda.synchronize()
        require([t.data_ptr() for t in out[4:7]] == ptrs, "window buffers not written in place")
        print(f"gla_decode_lazy_conv {tag} p{p}:")
        err_o = hold_lazy_step(torch, out, ref, p, TOL_BF16, own_max=True)
        if p in (0, 7, 15):
            equal_bits_again(torch, call, out)
        if p == 0:
            try:
                lazy_on_route(gla_cuda, "cluster", *tok, *taps, *k_rings, state_q,
                              *[t.clone() for t in k_bufs], p, s_scale=s_scale)
            except ValueError as e:
                print(f"  the cluster route refuses an int4 state: {e}")
            else:
                require(False, "the cluster route took an int4 state")
        if timed is not None:
            work = lazy_step_work(tok, taps, k_rings, state_q, s_scale, k_bufs, out, p)
            if b == BATCH and p == WINDOW - 1:
                record(summary, "gla_decode_lazy_conv_int4", err_o, *timed, *work, bf)
            else:
                note_shape("gla_decode_lazy_conv_int4", f"{tag} p{p}", *timed, *work, bf)
        INT4_HELD["gla_decode_lazy_conv"].add((b, H, DK, DV, bf, gla_cuda.INT4, WINDOW, p, "tile"))
        k_rings, k_bufs = out[1:4], list(out[4:8])
        p_rings, p_bufs = ref[1:4], list(ref[4:8])

    nibbles = lambda q: torch.cat(unpack_state_int4(q), -1).int()
    ref_q, ref_sc = gla_cuda.gla_fold_q_plain(state_q, s_scale, *p_bufs)
    parts_q, parts_sc = gla_cuda.gla_fold_q_parts_plain(state_q, s_scale, *p_bufs)
    q_in, sc_in = state_q.clone(), s_scale.clone()
    new_q, new_sc = gla_cuda.gla_fold_q(q_in, sc_in, *k_bufs)
    torch.cuda.synchronize()
    require(new_q.data_ptr() == q_in.data_ptr() and new_sc.data_ptr() == sc_in.data_ptr()
            and new_q.shape == state_q.shape, "int4 state not folded in place")
    print(f"gla_fold_q {tag}:")
    for label, rq, rsc in (("plain version", ref_q, ref_sc), ("plain mirror", parts_q, parts_sc)):
        steps = (nibbles(new_q) - nibbles(rq)).abs()
        top, off = int(steps.max()), int((steps > 0).sum())
        print(f"  int4 state vs the {label}: at most {top} steps, {off} of {steps.numel()} "
              "values differ")
        require(top <= 1 and off <= 1e-3 * steps.numel(), f"int4 state differs from the {label}")
        hold_leaf(f"s_scale vs the {label}", new_sc, rsc, 1e-5)
    require(not torch.equal(new_q, state_q), "the fold changed nothing")
    # one int4 step is 1/7 of a row's largest value: the dequantized state
    # within that of its max where a value landed one step apart
    err_s = hold_leaf("dequantized state", dequantize_state_int4(new_q, new_sc),
                      dequantize_state_int4(ref_q, ref_sc), 1 / 7 + TOL_BF16)
    INT4_HELD["gla_fold_q"].add((b, H, DK, DV, bf, gla_cuda.INT4, WINDOW))
    if summary is None:
        return
    ms, plain_ms = timed_pair(f"gla_fold_q {tag}", lambda: gla_cuda.gla_fold_q(*states(), *k_bufs),
                              lambda: gla_cuda.gla_fold_q_plain(*states(), *k_bufs), 50)
    work = (nbytes(state_q, state_q, s_scale, s_scale, *k_bufs),
            b * H * DK * (DV * (2 * WINDOW + 4) + 2 * WINDOW))
    if b == BATCH:
        record(summary, "gla_fold_q_int4", err_s, ms, plain_ms, *work, bf)
    else:
        note_shape("gla_fold_q_int4", tag, ms, plain_ms, *work, bf)


def int4_kernel_phase(torch, gla_cuda, summary):
    """The two int4 bodies (gla_decode_lazy_conv's tile route and gla_fold_q
    on an int4 state) held and timed over whole windows at b 1, 8 and 64
    (int4_window_check)."""
    for b in INT4_BATCHES:
        int4_window_check(torch, gla_cuda, b, summary)


def hold_launched_int4(torch, gla_cuda):
    """Every shape the driven paths launched the two int4 bodies on
    (INT4_LAUNCHED) held against the plain versions: a batch not held yet
    gets its whole window checked now."""
    launched = {name: set(c) for name, c in INT4_LAUNCHED.items()}
    todo = {shape[0] for name in launched for shape in launched[name] - INT4_HELD[name]}
    print(f"int4 bodies: the paths launched gla_decode_lazy_conv on "
          f"{len(launched['gla_decode_lazy_conv'])} int4 shapes and gla_fold_q on "
          f"{len(launched['gla_fold_q'])}; batches not held yet: {sorted(todo)}")
    for b in sorted(todo):
        int4_window_check(torch, gla_cuda, b)
    for name in launched:
        require(launched[name] and launched[name] <= INT4_HELD[name],
                f"{name}: launched on int4 shapes not held: {launched[name] - INT4_HELD[name]}")


def int4_generate_phase(torch, np, model, cfg, card_line):
    """The flagship of the generate phase with int4 lazy-window states:
    generate_batch(lazy_window=16, state_quant="int4") at b8 with 150-code
    prompts, greedy, launch counts against their formula; one window
    teacher-forced through the kernel path and the plain path (logits and
    every state leaf, the int4 states by their nibbles); a lazy
    DecodeServer(state_quant="int4") with 8 slots over 8 requests with
    150-code prompts, launch counts, the slot container's int4 s (dv / 2
    bytes a row) and float pos_net; every int4 shape launched held."""
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.attentive_rnn import add_lazy_buffers, map_state
    from lina_speech_tpu_torch.ops import gla_cuda
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    rng = np.random.default_rng(4)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook, size=(1, BATCH, T_PROMPT))).to(DEVICE)
    n_pre = T_PROMPT + 1
    windows = -(-(MAX_SEQLEN - n_pre) // WINDOW)
    lazy_steps = windows * WINDOW
    reset_counts()
    total = dict.fromkeys(read_counts(), 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = generate_batch(model, text, prompt=prompt, max_seqlen=MAX_SEQLEN, k=1,
                         force_max_seqlen=True, lazy_window=WINDOW, state_quant="int4")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"generate_batch(lazy_window={WINDOW}, state_quant=\"int4\"): {BATCH} requests, "
          f"{res.n_steps} steps ({windows} windows decoded), {wall:.3f} s wall [{card_line}]")
    print(f"launches: {launches}")
    # the 24 layer states are int4; the pos_net's stays in the state dtype
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_lazy_conv=N_GLA_LAYERS * lazy_steps,
                    gla_decode_lazy_conv_int4=(N_GLA_LAYERS - 1) * lazy_steps,
                    gla_fold_q=(N_GLA_LAYERS - 1) * windows,
                    gla_fold_q_int4=(N_GLA_LAYERS - 1) * windows, gla_fold=windows)
    require(res.tokens.shape == (cfg.n_quant, BATCH, MAX_SEQLEN) and int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < model.n_target_vocab, "int4 tokens out of range")
    add_launches(total, launches)

    # one lazy window teacher-forced through the kernel path and the plain
    # path from the same int4 states
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
        x_enc = model.encode_text(text)
        start = model.embed_tokens(torch.ones(1, BATCH, 1, dtype=torch.long, device=DEVICE))
        forced = torch.cat([start, model.embed_tokens(prompt + cfg.n_special_token_in)], 1)
        follow = model.embed_tokens(res.tokens[:, :, n_pre:n_pre + WINDOW])
        st0 = model.prefill(forced, x_enc, model.empty_state(BATCH, DEVICE))[2]
        base = add_lazy_buffers(st0, WINDOW, dtype=model.dtype, state_quant="int4")
        require(base.layers[0].s.shape == (BATCH, H, DK, DV // 2)
                and base.layers[0].s.dtype == torch.int8 and base.pos_net.s_scale is None,
                "int4 lazy buffers")
        runs = {}
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
                require(counts["gla_fold_q_int4"] == N_GLA_LAYERS - 1
                        and counts["gla_decode_lazy_conv_int4"] == (N_GLA_LAYERS - 1) * WINDOW,
                        f"the kernel path's int4 launches: {counts}")
            runs[mode] = (torch.stack(logits, 1), st)
        set_kernel_mode(model, "auto")
    torch.cuda.synchronize()
    print(f"one lazy window of {WINDOW} steps on int4 states, teacher-forced, kernel path vs "
          "plain path:")
    check("logits", max_err(runs["auto"][0], runs["chunk"][0]),
          bound(runs["chunk"][0], TOL_LOGITS))
    check_states("states after the fold, kernel path vs plain path", runs["auto"][1],
                 runs["chunk"][1], TOL_STATE,
                 live=("s", "s_scale", "conv_q", "conv_k", "conv_v", "kbuf", "vbuf", "cbuf"))

    # a lazy int4 server, 8 slots, 8 requests with 150-code prompts
    reqs = [(rng.integers(3, cfg.n_txt_vocab, size=TEXT_LEN),
             rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, T_PROMPT)), INT4_SERVE_MAX_LEN)
            for _ in range(SERVE_SLOTS)]
    srv = DecodeServer(model, n_slots=SERVE_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                       lazy=True, k=1, state_quant="int4")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done, n_chunks, chunk_ms = serve(torch, srv, reqs)
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"DecodeServer lazy, int4 states: {len(reqs)} requests through {SERVE_SLOTS} slots, "
          f"{n_chunks} decode chunks of {WINDOW}, {wall:.3f} s wall [{card_line}]")
    print(f"launches: {launches}")
    chunks = [_pow2_chunks(1 + T_PROMPT) for _ in reqs]
    later = sum(len(c) - 1 for c in chunks)
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS * len(reqs),
                    gla_chunk=N_GLA_LAYERS * later,
                    gla_decode_lazy_conv=N_GLA_LAYERS * WINDOW * n_chunks,
                    gla_decode_lazy_conv_int4=(N_GLA_LAYERS - 1) * WINDOW * n_chunks,
                    gla_fold_q=(N_GLA_LAYERS - 1) * n_chunks,
                    gla_fold_q_int4=(N_GLA_LAYERS - 1) * n_chunks, gla_fold=n_chunks)
    add_launches(total, launches)
    check_served(model, cfg, srv, reqs, done, chunks)
    report_chunk_times("lazy, int4 states", len(reqs), chunk_ms, card_line)
    for place, st in [("layer 0", srv._state.layers[0]), ("pos_net", srv._state.pos_net)]:
        int4 = place != "pos_net"
        want = (SERVE_SLOTS, H, DK, DV // 2 if int4 else DV)
        require(tuple(st.s.shape) == want and st.s.dtype == (torch.int8 if int4 else model.dtype)
                and (st.s_scale is not None) == int4 and bool(st.s.any()),
                f"slot container, {place}: s {tuple(st.s.shape)} {st.s.dtype}")
    print(f"  slot container: layer s {tuple(srv._state.layers[0].s.shape)} int8 (int4 packed), "
          f"pos_net s {tuple(srv._state.pos_net.s.shape)} {srv._state.pos_net.s.dtype}")
    hold_launched_int4(torch, gla_cuda)
    return total


# ---------------------------------------------------------- codec training
CODEC_GAN_STEPS, CODEC_GAN_BATCH, CODEC_GAN_CROP = 3, 2, 24000


def codec_gan_phase(torch, card_line):
    """codec GAN training at the full 320_24k width: ``train.codec_cli fit``
    in-process (WavTokenizerConfig(): 4096 bins, latent 512, backbone 768 /
    2304 x 12, n_fft 1280; MultiPeriodDiscriminator and
    MultiResolutionDiscriminator at their defaults; batch 2 of 24,000-sample
    crops of seeded noise), 3 alternating discriminator and generator
    steps, one validation pass (--val-every 2) and one checkpoint: finite
    losses and metrics, every tensor moved but the SEANet encoder's (no
    gradient reaches it) and the score heads' one-element biases (a zero
    hinge gradient while the scores lie inside the margins), the checkpoint
    equal to the trained generator bit for bit, no port kernel launched (the
    codec is plain PyTorch); ms a step and the peak device memory."""
    import shutil

    from lina_speech_tpu_torch.codec.discriminators import (
        MultiPeriodDiscriminator, MultiResolutionDiscriminator,
    )
    from lina_speech_tpu_torch.codec.gan import CodecGanConfig, create_codec_gan
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizer
    from lina_speech_tpu_torch.train import codec_cli
    from lina_speech_tpu_torch.utils.checkpoint import restore_checkpoint

    work = os.path.join(ROOT, "build", "codec_gan")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log = os.path.join(work, "metrics.jsonl")
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = codec_cli.main([
        "fit", "--steps", str(CODEC_GAN_STEPS), "--batch-size", str(CODEC_GAN_BATCH),
        "--crop-len", str(CODEC_GAN_CROP), "--val-every", "2", "--log-every", "1",
        "--ckpt-dir", os.path.join(work, "ckpt"), "--log-file", log, "--seed", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_launches(read_counts())
    recs = [json.loads(line) for line in open(log)]
    steps = [r for r in recs if "disc_loss" in r]
    vals = [r for r in recs if "val_si_snr_db" in r]
    require(len(steps) == CODEC_GAN_STEPS and len(vals) == 1, f"JSONL records {recs}")
    require(all(math.isfinite(v) for r in recs for v in r.values()), f"non-finite metrics {recs}")
    step_ms = [r["step_time_s"] * 1e3 for r in steps]
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("generator", state.gen), ("MPD", state.disc_mpd),
                                ("MRD", state.disc_mrd))}
    print(f"codec GAN fit: {n_params} parameters, {CODEC_GAN_STEPS} steps at batch "
          f"{CODEC_GAN_BATCH} x {CODEC_GAN_CROP} samples, {wall:.1f} s wall (builds included)")
    for r in steps:
        print(f"  step {r['step']}: disc {r['disc_loss']:.4f}, gen {r['gen_loss']:.4f} (mel "
              f"{r['mel_loss']:.4f}, adv {r['gen_adv']:.4f}, fm {r['fm_loss']:.4f}), "
              f"{r['step_time_s'] * 1e3:.1f} ms")
    print(f"  validation at step {vals[0]['step']}: SI-SNR {vals[0]['val_si_snr_db']:.3f} dB, "
          f"LSD {vals[0]['val_lsd_db']:.3f} dB, mel L1 {vals[0]['val_mel_l1']:.4f}")
    print(f"  ms a step (disc + gen, host clock to a device sync): {step_ms}; peak device "
          f"memory {peak:.2f} GiB [{card_line}]")

    # the parameters before training: the same modules drawn from the same seed
    wt0, mpd0, mrd0 = (WavTokenizer(codec_cli.codec_config(False)), MultiPeriodDiscriminator(),
                       MultiResolutionDiscriminator())
    create_codec_gan(torch.Generator().manual_seed(0), wt0, mpd0, mrd0, CodecGanConfig())
    for name, now, then in (("generator", state.gen, wt0), ("MPD", state.disc_mpd, mpd0),
                            ("MRD", state.disc_mrd, mrd0)):
        before = dict(then.named_parameters())
        moved = {k: bool((p.detach().cpu() != before[k]).any())
                 for k, p in now.named_parameters()}
        still = [k for k, m in moved.items() if not m]
        # the SEANet encoder takes no gradient (only weight decay, below an
        # f32 step here); a score head's one bias has a zero hinge gradient
        # while every score lies inside the margins (-1, 1)
        encoder = [k for k in still if ".encoder." in k]
        print(f"  {name}: {sum(moved.values())} of {len(moved)} tensors moved; not: "
              f"{len(encoder)} of the SEANet encoder and {[k for k in still if k not in encoder]}")
        must = [k for k in still if ".encoder." not in k and not k.endswith("conv_post.bias")]
        require(not must, f"{name}: tensors that did not move: {must[:8]}")
    saved = restore_checkpoint(os.path.join(work, "ckpt", f"step_{CODEC_GAN_STEPS}"),
                               map_location="cpu")
    require(saved["step"] == CODEC_GAN_STEPS and all(
        torch.equal(saved["model"][k], v.cpu()) for k, v in state.gen.state_dict().items()),
        "the checkpoint differs from the trained generator")
    print("  checkpoint restored equal to the trained generator bit for bit")
    shutil.rmtree(work, ignore_errors=True)
    del state
    torch.cuda.empty_cache()


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
    # kernel and memcpy rows only: CPU-op rows repeat their kernels' time, and
    # so does a schedule's step annotation
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev(e) > 0
              and not e.key.startswith("ProfilerStep")]
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


def profiled(torch, fn, what, top=8, groups=()):
    """Run ``fn`` once under torch.profiler and print its device profile
    (``groups`` as print_profile takes them). A warm-up step of dummy device
    work goes first and is discarded: the first events of a session can be
    lost."""
    from torch.profiler import ProfilerActivity, profile, schedule

    class Active:  # the active step's events, as print_profile reads them
        def key_averages(self):
            return self.events

    active = Active()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: setattr(active, "events", p.key_averages())) as prof:
        x = torch.ones(1 << 20, device=DEVICE)
        for _ in range(50):
            x = x * 1.0001
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    print_profile(active, what, wall_ms, top, groups)


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


def adversarial_gates(torch, gk):
    """Gates of -6 to -8 a step in every sixth key channel: a 64-row chunk's
    gate sum there is below -384, so e^{-bcum} would overflow f32 (the
    flagship's logsigmoid/16 gates have no clamp)."""
    g = torch.Generator(device=DEVICE).manual_seed(11)
    gk = gk.clone()
    gk[..., ::6] = -6.0 - 2.0 * torch.rand(gk[..., ::6].shape, generator=g, device=DEVICE)
    return gk


def hold_training_shape(torch, gla_cuda, b, t, st, need_ds0, need_taps, adversarial=False,
                        io=None):
    """gla_chunk_conv as a training path calls it (autograd recording, bf16
    IO) at one shape against its plain version: o, the final state and every
    gradient leaf, then the forward on each route its IO dtype has
    (hold_fwd_routes); the backward must take the chunked route. ``st`` is the
    initial state's dtype, or None for no initial state; ``adversarial``
    swaps in gates that would overflow a factorisation of the decay across a
    whole chunk; ``io`` float32 holds f32 IO instead, whose backward must
    take the recurrent route. Returns (inputs, do, dsf, gradients, largest
    error of a gradient leaf relative to its max|plain|)."""
    bf = torch.bfloat16
    io = io or bf
    need_ds0 = need_ds0 and st is not None
    x = kernel_inputs(torch, b, t, st, seed=300 + t)
    for n in ("xq", "xk", "xv", "wq", "wk", "wv"):
        x[n] = x[n].to(io)
    if adversarial:
        x["gk"] = adversarial_gates(torch, x["gk"])
    g = torch.Generator(device=DEVICE).manual_seed(t)
    do = torch.randn(b, H, t, DV, generator=g, device=DEVICE).to(io)
    dsf = torch.randn(b, H, DK, DV, generator=g, device=DEVICE).to(st or torch.float32)
    before = read_counts()
    routes = dict(gla_cuda.gla_chunk_conv_bwd.routes)
    o_k, s_k, got = conv_grads(torch, gla_cuda.gla_chunk_conv, x, do, dsf, need_ds0, need_taps)
    after = read_counts()
    o_p, s_p, ref = conv_grads(torch, gla_cuda.gla_chunk_conv_plain, x, do, dsf, need_ds0,
                               need_taps)
    torch.cuda.synchronize()
    require(after["gla_chunk_conv_bwd"] == before["gla_chunk_conv_bwd"] + 1
            and after["gla_chunk_conv"] == before["gla_chunk_conv"] + 1,
            "the gradient did not go through the forward and backward kernels")
    route = "chunked" if io == bf else "recurrent"
    routes[route] += 1
    require(gla_cuda.gla_chunk_conv_bwd.routes == routes,
            f"the {dtype_name(io)} backward did not take the {route} route: "
            f"{gla_cuda.gla_chunk_conv_bwd.routes}")
    state = "none" if st is None else dtype_name(st)
    name = (f"gla_chunk_conv b{b} t{t} IO {dtype_name(io)} initial state {state}"
            f"{'' if need_taps else ', no tap gradients'}"
            f"{'' if need_ds0 or st is None else ', no ds0'}"
            f"{', adversarial gates' if adversarial else ''}")
    print(f"{name}, forward:")
    require(o_k.dtype == io and s_k.dtype == s_p.dtype, "gla_chunk_conv output dtypes")
    tol_o, tol_s = TOL_BF16 if io == bf else TOL_F32, TOL_BF16 if st == bf else TOL_F32
    check("o", max_err(o_k, o_p), bound(o_p, tol_o))
    check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
    hold_fwd_routes(torch, gla_cuda, True, fwd_args(x, True), x["s0"], None, (o_p, s_p), tol_o,
                    tol_s)
    worst = check_grads(f"{name}, backward ({route} route)", got, ref, TOL_GRAD)
    if not adversarial and io == bf:
        HELD.add((b, t, st, need_ds0, need_taps))
    return x, do, dsf, got, worst


def bwd_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk_conv's forward and hand-written backward vs the plain
    version and autograd through it at the training shape (b8 h4 dk256
    dv512, bf16 IO, the backward's chunked route), t 512, 317 and 128, with
    an f32, a bf16 and no initial state, and at t512 with adversarial gates;
    times at t512 with the bf16 state, the backward beside PR 4's recurrent
    body, its scratch, equal bits on a second call and a profile by
    kernel. Then f32 IO (the recurrent route) at t512 with an f32 and a
    bf16 state, timed with the bf16 one."""
    bf = torch.bfloat16
    hold_training_shape(torch, gla_cuda, TRAIN_BATCH, TRAIN_T[0], bf, True, True,
                        adversarial=True)
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
            with torch.no_grad():
                o_k, s_k = gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
            fwd_work = (nbytes(*args, x["s0"], o_k, s_k), scan_flops(TRAIN_BATCH, t, True))
            fwd_bound, by = roofline(*fwd_work, bf)
            print(f"  gla_chunk_conv forward t{t}: kernel {fwd_ms:.6f} ms, plain "
                  f"{fwd_plain_ms:.6f} ms, bound {fwd_bound:.6f} ms by {by}")
            note_shape("gla_chunk_conv", f"training forward b{TRAIN_BATCH} t{t}", fwd_ms,
                       fwd_plain_ms, *fwd_work, bf)
            time_fwd_routes(torch, gla_cuda, True, args, x["s0"], None,
                            f"training forward b{TRAIN_BATCH} t{t}", fwd_work, iters=5)
            scratch = gla_cuda.chunked_fwd_scratch_bytes(TRAIN_BATCH, H, t, DK, DV,
                                                         gla_cuda.sm_count(x["xq"].device))
            print(f"  scratch of one chunked forward call: {scratch} bytes "
                  f"({scratch / 1e6:.1f} MB)")
            with torch.no_grad():
                again = gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
            torch.cuda.synchronize()
            require(torch.equal(again[0], o_k) and torch.equal(again[1], s_k),
                    "the chunked forward gave other bits on a second call")
            print("  gla_chunk_conv forward: equal bits on a second call")
            with torch.no_grad():
                profiled(torch, lambda: [gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
                                         for _ in range(3)],
                         f"3 calls of gla_chunk_conv forward t{t}", top=8)
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
            print(f"  gla_chunk_conv_bwd b{TRAIN_BATCH} t{t}, chunked route: "
                  f"{sum(ms) / len(ms) * 1e3:.1f} us a call (PR 4's recurrent body, PR 6 run: "
                  f"2,673 us)")
            mean = lambda xs: sum(xs) / len(xs)
            # the backward's max_abs_err is the largest error of a leaf as a
            # share of that leaf's max|plain|: the leaves' sizes differ 1e3-fold
            record(summary, "gla_chunk_conv_bwd", worst, mean(ms), mean(plain),
                   nbytes(*args, x["s0"], do, dsf, *got.values()),
                   bwd_flops(TRAIN_BATCH, t), bf)
            scratch = gla_cuda.chunked_bwd_scratch_bytes(TRAIN_BATCH, H, t, DK, DV)
            parts = 2 * (DV // 32) * TRAIN_BATCH * H * t * DK * 4
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            first = bwd()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base - nbytes(*first)
            print(f"  scratch of one chunked backward call: {scratch} bytes ({scratch / 1e6:.1f} "
                  f"MB; allocator peak beside the outputs {peak / 1e6:.1f} MB); the recurrent "
                  f"route's dq/dk parts alone: {parts / 1e6:.1f} MB")
            require(scratch < parts, "the chunked route's scratch is not below the parts'")
            second = bwd()
            torch.cuda.synchronize()
            require(all((a is None and r is None) or torch.equal(a, r)
                        for a, r in zip(first, second)),
                    "the chunked backward gave other bits on a second call")
            print("  gla_chunk_conv_bwd: equal bits on a second call")
            profiled(torch, lambda: [bwd() for _ in range(3)],
                     f"3 calls of gla_chunk_conv_bwd t{t}", top=8)
    # f32 IO keeps the recurrent body: held at the same shape, timed with
    # the bf16 state, and kept beside the chunked route's row of the summary
    t = TRAIN_T[0]
    for st in (torch.float32, bf):
        x, do, dsf, got, worst = hold_training_shape(
            torch, gla_cuda, TRAIN_BATCH, t, st, True, True, io=torch.float32)
    args = tuple(x[n] for n in GRAD_LEAVES[:7])
    ms = device_ms(lambda: gla_cuda.gla_chunk_conv_bwd(*args, x["s0"], do, dsf), 5)
    bound_ms, by = roofline(nbytes(*args, x["s0"], do, dsf, *got.values()),
                            bwd_flops(TRAIN_BATCH, t), torch.float32)
    print(f"  gla_chunk_conv_bwd b{TRAIN_BATCH} t{t} IO float32, recurrent route: kernel "
          f"{ms:.6f} ms, bound {bound_ms:.6f} ms by {by}")
    summary["gla_chunk_conv_bwd"]["recurrent_f32_io"] = dict(
        max_abs_err=worst, ms=ms, bound_ms=bound_ms, bound_by=by)


def read_launches(gla_cuda):
    """The wrappers' launch counts, with the shapes the two training kernels
    were launched on since the last reset noted in LAUNCHED."""
    shapes = gla_cuda.launch_shapes()
    LAUNCHED.update(shapes["gla_chunk_conv_bwd"])
    require({s[:3] for s in shapes["gla_chunk_conv_bwd"]}
            == {s[:3] for s in shapes["gla_chunk_conv"]},
            f"forward and backward launched on different shapes: {shapes}")
    return read_counts()


def launched_shapes_phase(torch, gla_cuda):
    """Every (batch, length, initial state, wanted gradients) the training,
    tuning, CLI, data and remat phases gave the forward and backward kernels
    is held against the plain version now, unless the backward kernel phase
    held it."""
    require(LAUNCHED, "the training and tuning phases noted no launch")
    new = sorted(LAUNCHED - HELD, key=str)
    print(f"the training, tuning, CLI, data and remat phases launched gla_chunk_conv and its "
          f"backward on "
          f"{len(LAUNCHED)} shapes, {len(new)} of them not held yet:")
    for b, t, st, need_ds0, need_taps in new:
        hold_training_shape(torch, gla_cuda, b, t, st, need_ds0, need_taps)
    require(LAUNCHED <= HELD, f"launched but not held: {sorted(LAUNCHED - HELD, key=str)}")


def expect_chunked_route(gla_cuda, bwd, launches):
    """Every launch of the backward ``bwd`` since the last reset took the
    chunked route where its IO dtype is bf16 and was counted under the route
    its plan gives: the conv-fused backward (the flagship computes in bf16)
    all chunked; gla_chunk_bwd chunked for bf16 IO (simple-GLA), recurrent
    for f32 IO (Mamba-2); rwkv6_chunk_bwd chunked for bf16 IO at or above
    its plan's threshold, recurrent below it and for f32 IO (the f32-compute
    check copy); mamba_scan_bwd at the chunk length its plan gives."""
    import torch

    if bwd == "gla_chunk_conv_bwd":
        routes = gla_cuda.gla_chunk_conv_bwd.routes
        require(routes == {"recurrent": 0, "chunked": launches[bwd]},
                f"gla_chunk_conv_bwd routes {routes}, launches {launches[bwd]}: a bf16 launch "
                "did not take the chunked route")
    elif bwd == "gla_chunk_bwd":
        want = dict.fromkeys(gla_cuda.gla_chunk_bwd.routes, 0)
        for shape, n in gla_cuda.launch_shape_counts()[bwd].items():
            (b, h, t), dv, io = shape[:3], shape[4], shape[5]
            route = gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)
            require(route == "chunked" or io != torch.bfloat16,
                    f"gla_chunk_bwd: the plan sends the bf16 launch on {shape} to the {route} "
                    "route")
            want[route] += n
        require(gla_cuda.gla_chunk_bwd.routes == want and sum(want.values()) == launches[bwd],
                f"gla_chunk_bwd routes {gla_cuda.gla_chunk_bwd.routes}, planned {want}, "
                f"launches {launches[bwd]}")
        print(f"  gla_chunk_bwd routes as planned: {want}")
    elif bwd == "rwkv6_chunk_bwd":
        from lina_speech_tpu_torch.ops import rwkv6_cuda

        want = dict.fromkeys(rwkv6_cuda.rwkv6_chunk_bwd.routes, 0)
        for shape, n in rwkv6_cuda.launch_shape_counts()[bwd].items():
            (b, h, t), dv, io, route = shape[:3], shape[4], shape[5], shape[-1]
            planned = rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, h, t, dv)
            require(route == planned, f"rwkv6_chunk_bwd: the launch on {shape} did not take its "
                    f"planned {planned} route")
            require(route == "chunked" or io != torch.bfloat16
                    or t < rwkv6_cuda._BWD_CHUNKED_MIN_T,
                    f"rwkv6_chunk_bwd: a bf16 launch at or above the threshold on {shape} took "
                    f"the {route} route")
            want[route] += n
        require(rwkv6_cuda.rwkv6_chunk_bwd.routes == want and sum(want.values()) == launches[bwd],
                f"rwkv6_chunk_bwd routes {rwkv6_cuda.rwkv6_chunk_bwd.routes}, planned {want}, "
                f"launches {launches[bwd]}")
        print(f"  rwkv6_chunk_bwd routes as planned: {want}")
    elif bwd == "mamba_scan_bwd":
        from lina_speech_tpu_torch.ops import mamba_cuda

        want = dict.fromkeys(mamba_cuda.mamba_scan_bwd.routes, 0)
        for shape, n in mamba_cuda.launch_shape_counts()[bwd].items():
            (b, t, d), chunk = shape[:3], shape[-1]
            planned = mamba_cuda.mamba_scan_bwd_plan(b, t, d)
            require(chunk == planned, f"mamba_scan_bwd: the launch on {shape} did not take its "
                    f"planned chunk length {planned}")
            want[mamba_cuda.bwd_route(t, chunk)] += n
        require(mamba_cuda.mamba_scan_bwd.routes == want and sum(want.values()) == launches[bwd],
                f"mamba_scan_bwd routes {mamba_cuda.mamba_scan_bwd.routes}, planned {want}, "
                f"launches {launches[bwd]}")
        print(f"  mamba_scan_bwd routes as planned: {want}")


# device time of a profiled train step by the kernels of the GLA and RWKV6
# layers, each kernel in one group (a key names its namespace: RWKV6's
# kernels carry GLA's names inside theirs): the GLA forward's chunked
# kernels live in gla::chunked_fwd, the backward's in gla::chunked (whose
# name is not a prefix of the other's), RWKV6's chunked forward in
# rwkv6::chunked_fwd, its chunked backward in rwkv6::chunked_bwd
TRAIN_GROUPS = (("GLA backward, chunked kernels", ("gla::chunked::",)),
                ("GLA backward, recurrent sweeps", ("gla::bwd_dq_kernel", "gla::bwd_dkv_kernel")),
                ("GLA backward, finishing pass (RWKV6's too: its dw carry)",
                 ("gla::bwd_finish_kernel", "gla::bwd_finish_qk_kernel",
                  "gla::bwd_dg_carry_kernel", "gla::bwd_taps_kernel")),
                ("GLA forward, chunked kernels", ("gla::chunked_fwd::",)),
                ("GLA forward, recurrent body", ("gla::gla_chunk_kernel",)),
                ("RWKV6 forward, chunked kernels", ("rwkv6::chunked_fwd::",)),
                ("RWKV6 forward, recurrent body", ("rwkv6::rwkv6_chunk_kernel",)),
                ("RWKV6 backward, chunked kernels", ("rwkv6::chunked_bwd::",)),
                ("RWKV6 backward, recurrent sweeps", ("rwkv6::rwkv6_bwd_dr_kernel",
                                                      "rwkv6::rwkv6_bwd_dkv_kernel")),
                ("RWKV6 backward, finishing pass and du", ("rwkv6::rwkv6_bwd_finish_kernel",
                                                           "rwkv6::rwkv6_bwd_du_kernel")))


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
        expect_chunked_route(gla_cuda, bwd, launches)
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
    print(f"profiled step: b{TRAIN_BATCH}, t {batch['y_mask'].shape[1]}, "
          f"{int(batch['y_mask'].sum())} frames [{card_line}]")
    profiled(torch, lambda: steps[1](state, batch, gen),
             f"one train step b8 ({cfg.backbone.kind})", top=10, groups=TRAIN_GROUPS)
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
    small = batch_to_device(check_batch(cfg), DEVICE)
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
            launches = read_launches(gla_cuda)
            expect_launches(launches, **{fwd: N_GLA_LAYERS, bwd: N_GLA_LAYERS})
            expect_chunked_route(gla_cuda, bwd, launches)
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
    expect_chunked_route(gla_cuda, bwd, launches)
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


# ------------------------------------------- the training entry point and real data
CLI_CONFIG = os.path.join(ROOT, "configs", "lina_gla_169m.yaml")
CLI_STEPS = 3  # fit's steps before the checkpoint is restored and resumed
DATA_WAVS, DATA_SEED, DATA_SHARD = 16, 24, 8  # WAV files, their seed, utterances a shard
REMAT_AUDIO = 510  # codes a row: collated with head and tail to t 512


def scratch_dir(name):
    """An empty directory ``build/chip_smoke/<name>`` (git-ignored) for a
    phase's files; the phase removes it when it ends."""
    import shutil

    path = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def fit_main(cli, argv):
    """``cli.main(argv)`` with its output echoed; returns (the final
    TrainState, what it printed)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = cli.main(argv)
    print(buf.getvalue(), end="")
    return state, buf.getvalue()


def log_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def hold_fit_log(np, records, steps):
    """The JSONL records of ``fit`` at ``--log-every 1``: one a step, with a
    finite loss and a finite, non-zero grad_norm."""
    require([r["step"] for r in records] == list(steps), f"logged steps {records}")
    for r in records:
        require(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0,
                f"step {r['step']}: loss {r['loss']}, grad_norm {r['grad_norm']}")


def cli_phase(torch, np, gla_cuda, card_line):
    """``python -m lina_speech_tpu_torch.train.cli fit`` in-process on
    configs/lina_gla_169m.yaml as it stands (the flagship, synthetic b8,
    audio 128-512) for CLI_STEPS steps with a checkpoint directory: the
    parameter count, finite losses and grad norms, 25 + 25 row-1 launches a
    step; the final checkpoint restored onto the card equal to the live
    state bit for bit (parameters, both Adam moments, the step); then
    ``--resume --steps CLI_STEPS+1``, which must start at step CLI_STEPS and
    write step_<CLI_STEPS+1>. The directory (about 4.3 GB a checkpoint) is
    removed at the end. Returns the launch counts."""
    import shutil

    from lina_speech_tpu_torch.train import cli
    from lina_speech_tpu_torch.utils.checkpoint import (
        STATE_FILE, checkpoint_steps, restore_checkpoint,
    )

    started = time.perf_counter()
    ckdir = scratch_dir("cli")
    log = os.path.join(ckdir, "log.jsonl")
    argv = ["fit", "--config", CLI_CONFIG, "--log-every", "1", "--ckpt-dir", ckdir,
            "--log-file", log]
    total = dict.fromkeys(read_counts(), 0)
    try:
        free = shutil.disk_usage(ckdir).free
        print(f"cli phase: fit --config {os.path.relpath(CLI_CONFIG, ROOT)} --steps {CLI_STEPS} "
              f"on the card ({free / 2**30:.1f} GiB free for the checkpoints)")
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _ = fit_main(cli, argv + ["--steps", str(CLI_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gla_cuda)
        expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS * CLI_STEPS,
                        gla_chunk_conv_bwd=N_GLA_LAYERS * CLI_STEPS)
        expect_chunked_route(gla_cuda, "gla_chunk_conv_bwd", launches)
        add_launches(total, launches)
        n_params = sum(p.numel() for p in state.model.parameters())
        require(n_params == N_PARAMS, f"{n_params} parameters, expected {N_PARAMS}")
        records = log_records(log)
        hold_fit_log(np, records, range(CLI_STEPS))
        for r in records:
            print(f"  step {r['step']}: loss {r['loss']:.4f}, grad_norm {r['grad_norm']:.4f}, "
                  f"{r['step_time_s'] * 1e3:.1f} ms [{card_line}]")
        size = os.path.getsize(os.path.join(ckdir, f"step_{CLI_STEPS}", STATE_FILE))
        print(f"  fit: {n_params:,} parameters, {CLI_STEPS} steps and the checkpoint in "
              f"{wall:.1f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB; checkpoint {size / 1e9:.2f} GB [{card_line}]")
        require(checkpoint_steps(ckdir) == [CLI_STEPS], f"checkpoints {checkpoint_steps(ckdir)}")

        t0 = time.perf_counter()
        full = restore_checkpoint(os.path.join(ckdir, f"step_{CLI_STEPS}"), map_location=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(full["step"] == state.step == CLI_STEPS, f"step {full['step']} / {state.step}")
        differ = [n for n, p in state.model.named_parameters()
                  if not torch.equal(full["model"][n], p)]
        live, saved = state.optimizer.state_dict()["state"], full["optimizer"]["state"]
        require(sorted(live) == sorted(saved) == list(range(len(list(state.model.parameters())))),
                f"optimizer state of {len(live)} / {len(saved)} tensors")
        moments = [(i, k) for i in live for k in ("step", "exp_avg", "exp_avg_sq")
                   if not torch.equal(live[i][k].to(saved[i][k].device), saved[i][k])]
        require(not differ and not moments,
                f"restored state differs: parameters {differ[:4]}, moments {moments[:4]}")
        print(f"  restored step_{CLI_STEPS} onto the card in {restore_s:.1f} s: {n_params:,} "
              f"parameters, both Adam moments of {len(live)} tensors and the step equal to the "
              "live state bit for bit")
        del full, live, saved, state
        torch.cuda.empty_cache()

        reset_counts()
        state, out = fit_main(cli, argv + ["--steps", str(CLI_STEPS + 1), "--resume"])
        torch.cuda.synchronize()
        launches = read_launches(gla_cuda)
        expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS, gla_chunk_conv_bwd=N_GLA_LAYERS)
        expect_chunked_route(gla_cuda, "gla_chunk_conv_bwd", launches)
        add_launches(total, launches)
        require(f"resuming from step {CLI_STEPS}" in out, "the resumed run did not say its step")
        hold_fit_log(np, log_records(log)[CLI_STEPS:], [CLI_STEPS])
        require(state.step == CLI_STEPS + 1
                and checkpoint_steps(ckdir) == [CLI_STEPS, CLI_STEPS + 1],
                f"resumed to step {state.step}, checkpoints {checkpoint_steps(ckdir)}")
        print(f"  --resume: started at step {CLI_STEPS}, wrote step_{CLI_STEPS + 1}")
        del state
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"cli phase took {time.perf_counter() - started:.1f} s [{card_line}]")
    return total


def write_wav(path, x, sample_rate, float32):
    """A mono RIFF/WAVE file: IEEE float32, or PCM16."""
    import struct

    import numpy as np

    if float32:
        data, code, bits = x.astype("<f4").tobytes(), 3, 32
    else:
        data, code, bits = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes(), 1, 16
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, code, 1, sample_rate,
                                sample_rate * bits // 8, bits // 8, bits)
    body = fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def data_phase(torch, np, gla_cuda, card_line):
    """The real-data side: DATA_WAVS WAV files made from DATA_SEED, 2-6 s of
    noise under a voiced-like carrier, PCM16 and float32, two of them at 16
    kHz named ``<name>@16000.wav``; scripts/prepare_dataset_torch.py
    tokenizes them on the card into two shards with the full-width codec
    (WavTokenizerConfig(), random weights from DATA_SEED); every row's codes
    equal the card codec's encode of the same audio and are held against
    the same codec on the CPU (latents within TOL_CODEC of their own max,
    codes equal but for near-ties, as pipeline_phase holds them); then fit
    trains the flagship (the YAML's model section unchanged) two steps on
    ``data.kind: npz`` over the shards. Returns fit's launch counts."""
    import copy
    import importlib.util
    import shutil

    import yaml

    from lina_speech_tpu_torch.codec.vq import vq_encode
    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
    from lina_speech_tpu_torch.data.dataset import TokenizedTTSDataset
    from lina_speech_tpu_torch.train import cli

    started = time.perf_counter()
    work = scratch_dir("data")
    total = dict.fromkeys(read_counts(), 0)
    try:
        rng = np.random.default_rng(DATA_SEED)
        lines, seconds = [], 0.0
        for i in range(DATA_WAVS):
            rate = 16000 if i in (3, 10) else 24000
            n = int(rate * (2.0 + 4.0 * rng.random()))
            t = np.arange(n) / rate
            x = (0.3 * np.sin(2 * np.pi * (110 + 20 * i) * t) * (1 + np.sin(2 * np.pi * 3 * t))
                 + 0.05 * rng.normal(size=n)) * 0.6
            name = f"utt{i:02d}@16000.wav" if rate == 16000 else f"utt{i:02d}.wav"
            write_wav(os.path.join(work, name), x.astype(np.float32), rate, float32=i % 2 == 1)
            lines.append(f"{os.path.join(work, name)}\t{PIPE_TEXT.split()[i % 9]} utterance {i}\n")
            seconds += n / rate
        manifest = os.path.join(work, "files.tsv")
        with open(manifest, "w") as f:
            f.writelines(lines)
        spec = importlib.util.spec_from_file_location(
            "prepare_dataset_torch", os.path.join(ROOT, "scripts", "prepare_dataset_torch.py"))
        prep = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(prep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shards = prep.main(["--manifest", manifest, "--out", os.path.join(work, "shards"),
                            "--shard-size", str(DATA_SHARD), "--seed", str(DATA_SEED)])
        prep_s = time.perf_counter() - t0
        require(len(shards) == DATA_WAVS // DATA_SHARD, f"shards {shards}")
        ds = TokenizedTTSDataset(npz_paths=shards)
        require(len(ds) == DATA_WAVS, f"{len(ds)} utterances in the shards")
        print(f"data phase: prepare_dataset_torch.py tokenized {DATA_WAVS} WAVs ({seconds:.1f} s "
              f"of audio, PCM16 and float32, two at 16 kHz) into {len(shards)} shards on the "
              f"card in {prep_s:.1f} s (the codec's build included) [{card_line}]")

        wcfg = WavTokenizerConfig()
        wavtok = build_wavtokenizer(wcfg, seed=DATA_SEED)
        cpu_codec = copy.deepcopy(wavtok).cpu()
        worst = 0.0
        for line, item in zip(lines, ds.items):
            path, text = line.rstrip("\n").split("\t")
            require(item["text"] == text, f"{path}: text {item['text']!r}")
            audio = torch.from_numpy(prep.load_utterance(path, wcfg.sample_rate,
                                                         wcfg.hop_length))[None]
            with torch.no_grad():
                card_latents = wavtok.encoder(audio.to(DEVICE))
                card_codes = vq_encode(card_latents, wavtok.quantizer, wcfg.n_q)
                cpu_latents = cpu_codec.encoder(audio)
                cpu_codes = vq_encode(cpu_latents, cpu_codec.quantizer, wcfg.n_q)
            shard_codes = torch.from_numpy(item["audio_token"])[:, None]
            require(tuple(shard_codes.shape) == (wcfg.n_q, 1, audio.shape[1] // wcfg.hop_length)
                    and torch.equal(shard_codes, card_codes.cpu()),
                    f"{path}: the shard's codes are not the card codec's encode")
            err = max_err(card_latents.cpu(), cpu_latents)
            ref = float(cpu_latents.abs().max())
            worst = max(worst, err / ref)
            check(f"{os.path.basename(path)} latents", err, TOL_CODEC * ref)
            hold_codes(shard_codes, cpu_codes, card_latents, cpu_latents,
                       cpu_codec.quantizer.embed[0])
        print(f"  {DATA_WAVS} rows: the shards' codes equal the card codec's, held against the "
              f"CPU's (latents within {worst:.2e} of their own max)")
        del wavtok, cpu_codec

        with open(CLI_CONFIG) as f:
            raw = yaml.safe_load(f)
        raw["data"] = {"kind": "npz", "npz_paths": shards, "quant_layer": [0],
                       "batch_size": TRAIN_BATCH}
        config = os.path.join(work, "npz.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(raw, f)
        log = os.path.join(work, "log.jsonl")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = fit_main(cli, ["fit", "--config", config, "--steps", "2", "--log-every", "1",
                                  "--log-file", log])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(gla_cuda)
        expect_launches(launches, gla_chunk_conv=2 * N_GLA_LAYERS,
                        gla_chunk_conv_bwd=2 * N_GLA_LAYERS)
        expect_chunked_route(gla_cuda, "gla_chunk_conv_bwd", launches)
        add_launches(total, launches)
        records = log_records(log)
        hold_fit_log(np, records, range(2))
        require(sum(p.numel() for p in state.model.parameters()) == N_PARAMS, "parameters")
        print(f"  fit on the npz shards: the flagship, 2 steps in {wall:.1f} s (build included), "
              f"losses {[round(r['loss'], 4) for r in records]}, grad norms "
              f"{[round(r['grad_norm'], 4) for r in records]} [{card_line}]")
        del state
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"data phase took {time.perf_counter() - started:.1f} s [{card_line}]")
    return total


def train_grads(torch, model, batch, seed):
    """:func:`model_grads` in training mode, as make_train_step runs the
    forward: dropout and text masking from a generator seeded with
    ``seed``."""
    model.train()
    model.set_generator(torch.Generator(device=DEVICE).manual_seed(seed))
    try:
        return model_grads(torch, model, batch)
    finally:
        model.eval()


def remat_phase(torch, np, gla_cuda, card_line):
    """``backbone.remat``: the flagship built twice from seed 0, remat off
    and on, one training forward and backward each on the same b8 batch (t
    512) with the same generator: 25 gla_chunk_conv launches and 25
    backwards without remat, 49 (the 24 encoder and decoder blocks
    recomputed; the pos_net is not rematerialized, as in JAX) and 25 with
    it; parameter gradients with equal bits (a second run without remat
    gives the spread to fall back on, should a kernel prove
    non-deterministic); the peak device memory and the warm ms (each
    model's second run) of both, and a profile of a third run of each.
    Returns the launch counts."""
    from lina_speech_tpu_torch.config import build_model, lina_gla_169m
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.train.harness import batch_to_device

    started = time.perf_counter()
    total = dict.fromkeys(read_counts(), 0)
    flagship = lina_gla_169m(compute_dtype="bfloat16")
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=TRAIN_BATCH, n_codebook=flagship.n_codebook, min_audio_len=REMAT_AUDIO,
        max_audio_len=REMAT_AUDIO, seed=7)), DEVICE)
    t = batch["y_mask"].shape[1]
    require(t == 512, f"batch t {t}")
    grads, peaks, times = {}, {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(flagship, backbone=dataclasses.replace(
            flagship.backbone, remat=remat))
        model = build_model(cfg, device=DEVICE, seed=0)
        require(model.attentive_rnn.remat == remat, "remat not set")
        runs = ("plain", "plain again") if not remat else ("remat", "remat again")
        for run in runs:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loss, g = train_grads(torch, model, batch, seed=5)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - base
            launches = read_launches(gla_cuda)
            recomputed = 2 * cfg.backbone.n_layer if remat else 0
            expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS + recomputed,
                            gla_chunk_conv_bwd=N_GLA_LAYERS)
            expect_chunked_route(gla_cuda, "gla_chunk_conv_bwd", launches)
            add_launches(total, launches)
            grads[run], peaks[run], times[run] = g, peak, ms
            print(f"  {run}: loss {loss:.6f}, forward and backward {ms:.1f} ms, peak device "
                  f"memory above the model {peak / 2**30:.2f} GiB ({peak} bytes) [{card_line}]")
        profiled(torch, lambda: train_grads(torch, model, batch, seed=5),
                 f"forward and backward b{TRAIN_BATCH} t{t}, remat {remat}", top=6,
                 groups=TRAIN_GROUPS[:5])
        del model
        torch.cuda.empty_cache()
    ref, again, got = grads["plain"], grads["plain again"], grads["remat"]
    spread = {n: float((again[n] - ref[n]).abs().max()) for n in ref}
    moved = {n: max(float((got[n] - ref[n]).abs().max()),
                    float((grads["remat again"][n] - ref[n]).abs().max())) for n in ref}
    noisy = sorted(n for n, s in spread.items() if s > 0)
    if not noisy:
        require(not any(moved.values()),
                f"remat changes gradients bit for bit: {[n for n, v in moved.items() if v][:6]}")
        print(f"  gradients: all {len(ref)} parameter tensors equal bit for bit with and without "
              "remat (two runs each)")
    else:
        print(f"  two runs without remat differ on {len(noisy)} tensors (a non-deterministic "
              f"kernel): {noisy[:8]}")
        over = [n for n in ref if moved[n] > spread[n]]
        require(not over, f"remat moves gradients beyond the spread of two runs: {over[:6]}")
        print(f"  gradients with remat within that spread on all {len(ref)} tensors")
    require(all(bool(torch.isfinite(v).all()) for v in got.values()), "non-finite gradients")
    print(f"  b{TRAIN_BATCH} t{t}, warm (each second run): forward and backward "
          f"{times['plain again']:.1f} ms without remat, {times['remat again']:.1f} ms with; "
          f"peak device memory above the model {peaks['plain again'] / 2**30:.2f} GiB without, "
          f"{peaks['remat again'] / 2**30:.2f} GiB with [{card_line}]")
    del grads, ref, again, got
    torch.cuda.empty_cache()
    print(f"remat phase took {time.perf_counter() - started:.1f} s [{card_line}]")
    return total


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


BWD_OUTS = ("q", "k", "v", "gk", "s0")  # the leaves of gla_chunk_bwd's five outputs


def bwd_on_route(gla_cuda, x, do, dsf, scale, need_ds0, route):
    """gla_chunk_bwd on ``x`` (qkv_inputs) through the wrapper's launcher,
    forced onto ``route`` (the public wrapper takes the plan's); returns
    {leaf: gradient} of the leaves that came back."""
    out = gla_cuda._chunk_bwd_launch(x["q"], x["k"], x["v"], x["gk"], x["s0"], do, dsf, scale,
                                     need_ds0, route)
    return {n: g for n, g in zip(BWD_OUTS, out) if g is not None}


def hold_bwd_routes(torch, gla_cuda, name, x, do, dsf, scale, need_ds0, ref, tol, planned,
                    got):
    """gla_chunk_bwd with bf16 IO on the route other than ``planned`` (whose
    gradients ``got`` autograd's launch gave) against ``ref``, the gradients
    of autograd through the plain version, each leaf within ``tol`` of its
    own max|plain|, finite and non-zero; then the chunked route's against
    gla_chunk_bwd_chunked_plain, the same decomposition with tensors and the
    kernels' bf16 rounding points, within TOL_BF16."""
    other = "recurrent" if planned == "chunked" else "chunked"
    forced = bwd_on_route(gla_cuda, x, do, dsf, scale, need_ds0, other)
    torch.cuda.synchronize()
    check_grads(f"{name}, backward forced onto the {other} route", forced, ref, tol)
    chunked = got if planned == "chunked" else forced
    plain = gla_cuda.gla_chunk_bwd_chunked_plain(
        x["q"], x["k"], x["v"], x["gk"], x["s0"], do, dsf, scale, operand_dtype=torch.bfloat16)
    plain = {n: g for n, g in zip(BWD_OUTS, plain) if n in chunked}
    check_grads(f"{name}, chunked route vs its plain decomposition", chunked, plain, TOL_BF16)


def hold_chunk(torch, gla_cuda, shape, need_ds0=None, adversarial=False):
    """gla_chunk at ``shape`` = (b, h, t, dk, dv, IO dtype, initial-state
    dtype or None, scale) against its plain version: with ``need_ds0`` None
    the inference forward (o, final state); otherwise as training calls it
    (autograd recording: the forward kernel and the hand-written backward
    on its planned route) against autograd through the plain version, o,
    the final state and every gradient leaf each within a share of its own
    max|plain|, and with bf16 IO the backward on both routes
    (hold_bwd_routes). Then the forward on each route its IO dtype has
    (hold_fwd_routes). ``adversarial`` swaps in gates that would overflow a
    factorisation of the decay across a whole chunk (the shape is then not
    noted as held). Returns (inputs, do, dsf, gradients, worst gradient
    share)."""
    b, h, t, dk, dv, io, st, scale = shape
    x = qkv_inputs(torch, b, h, t, dk, dv, io, st, seed=400 + t + h)
    if adversarial:
        x["gk"] = adversarial_gates(torch, x["gk"])
    state = "none" if st is None else str(st).split(".")[-1]
    name = (f"gla_chunk b{b} {head_name(h, dk, dv)} t{t} IO {str(io).split('.')[-1]} "
            f"initial state {state} scale {scale:g}{', adversarial gates' if adversarial else ''}")
    tol = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    tol_s = TOL_BF16 if torch.bfloat16 in (io, st) else TOL_F32
    before = gla_cuda.launch_counts()
    routes = dict(gla_cuda.gla_chunk_bwd.routes)
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
        routes[gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)] += 1
    after = gla_cuda.launch_counts()
    torch.cuda.synchronize()
    require(after["gla_chunk"] == before["gla_chunk"] + 1
            and after["gla_chunk_bwd"] == before["gla_chunk_bwd"] + (need_ds0 is not None),
            f"{name}: not launched through the kernels")
    require(gla_cuda.gla_chunk_bwd.routes == routes,
            f"{name}: the backward did not take its planned route: {gla_cuda.gla_chunk_bwd.routes}")
    print(f"{name}, forward:")
    require(o_k.dtype == io and s_k.dtype == (st or torch.float32), "gla_chunk output dtypes")
    check("o", max_err(o_k, o_p), bound(o_p, tol))
    check("final state", max_err(s_k, s_p), bound(s_p, tol_s))
    fwd_routes = hold_fwd_routes(torch, gla_cuda, False, fwd_args(x, False), x["s0"], scale,
                                 (o_p, s_p), tol, tol_s)
    if not adversarial:
        CHUNK_HELD.update((*shape, route) for route in fwd_routes)
    if need_ds0 is not None:
        tol_g = TOL_GRAD if torch.bfloat16 in (io, st) else TOL_F32
        planned = gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)
        worst = check_grads(f"{name}, backward ({planned} route)", got, ref, tol_g)
        if io == torch.bfloat16:
            hold_bwd_routes(torch, gla_cuda, name, x, do, dsf, scale, need_ds0, ref, tol_g,
                            planned, got)
        if not adversarial:
            CHUNK_BWD_HELD.add((*shape, need_ds0 and st is not None))
        result = (x, do, dsf, got, worst)
    return result


# lengths at which gla_chunk_bwd's two routes are timed against each other,
# to check the plan (ops/gla_cuda.py:gla_chunk_bwd_plan)
BWD_SWEEP_T = (16, 32, 48, 64, 128, 256, 512)
TUNE_BATCH = 2  # initial-state tuning's batch (tuning_phase)


def bwd_work(x, do, dsf, got):
    """(bytes, operations) of one gla_chunk_bwd call: its inputs and
    outputs, and the recurrence's backward operations."""
    b, h, t, dk = x["q"].shape
    return (nbytes(x["q"], x["k"], x["v"], x["gk"], x["s0"], do, dsf, *got.values()),
            plain_qkv_flops(b, h, t, dk, x["v"].shape[-1], backward=True))


def time_bwd_routes(torch, gla_cuda, x, do, dsf, scale, label, margin=0.0, iters=5,
                    need_ds0=True):
    """Device ms of gla_chunk_bwd on each route its IO dtype has, on the same
    inputs, in turns (recurrent, chunked, chunked, recurrent); where
    gla_chunk_bwd_plan takes the chunked route it must be faster than the
    recurrent body, or no more than ``margin`` slower (the route sweep).
    Returns {route: mean ms}."""
    b, h, t = x["q"].shape[:3]
    io, dv = x["q"].dtype, x["v"].shape[-1]
    routes = ("recurrent", "chunked") if io == torch.bfloat16 else ("recurrent",)
    times = {r: [] for r in routes}
    for route in (*routes, *reversed(routes)):
        times[route].append(device_ms(
            lambda: bwd_on_route(gla_cuda, x, do, dsf, scale, need_ds0, route), iters))
    ms = {route: sum(v) / len(v) for route, v in times.items()}
    planned = gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)
    print(f"  gla_chunk_bwd {label} routes, device ms: "
          + ", ".join(f"{r} {times[r]}" for r in routes) + f"; the plan takes {planned}")
    if planned == "chunked":
        limit = ms["recurrent"] * (1 + margin)
        require(ms["chunked"] < limit,
                f"gla_chunk_bwd {label}: the plan takes the chunked route, but it is slower than "
                f"{limit} ms: {ms}")
    return ms


def bwd_inputs(torch, b, h, t, dk, dv, io, st, seed):
    """qkv_inputs with do and dsf: (inputs, do, dsf)."""
    x = qkv_inputs(torch, b, h, t, dk, dv, io, st, seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    do = torch.randn(b, h, t, dv, generator=g, device=DEVICE).to(io)
    dsf = torch.randn(b, h, dk, dv, generator=g, device=DEVICE).to(st or torch.float32)
    return x, do, dsf


def bwd_route_sweep(torch, gla_cuda):
    """gla_chunk_bwd's two routes at b1, b2 and b8 over BWD_SWEEP_T
    (simple-GLA's heads, bf16 IO, no initial state, as its training runs):
    device ms of each; where the plan takes the chunked route it may be no
    more than SWEEP_MARGIN slower."""
    h, dk, dv = SIMPLE_HEAD
    print("backward route sweep (device ms, recurrent vs chunked):")
    for b in (1, TUNE_BATCH, TRAIN_BATCH):
        for t in BWD_SWEEP_T:
            x, do, dsf = bwd_inputs(torch, b, h, t, dk, dv, torch.bfloat16, None, seed=800 + t)
            time_bwd_routes(torch, gla_cuda, x, do, dsf, dk ** -0.5,
                            f"sweep b{b} {head_name(h, dk, dv)} t{t}", margin=SWEEP_MARGIN)


def time_chunk_bwd(torch, gla_cuda, summary, shape, x, do, dsf, got, worst):
    """Times of gla_chunk's forward and backward at ``shape`` (no initial
    state, what training runs): the backward on each route its IO dtype has
    beside its bound and the plain version's eager time, its scratch on
    each route, equal bits on a second call and a profile of three calls
    by kernel. simple-GLA's bf16 shape is the summary's row."""
    b, h, t, dk, dv, io, _, scale = shape
    bf = torch.bfloat16
    head = head_name(h, dk, dv)
    args = (x["q"], x["k"], x["v"], x["gk"])
    with torch.no_grad():
        fwd_ms, fwd_plain_ms = timed_pair(
            f"gla_chunk forward {head} t{t}", lambda: gla_cuda.gla_chunk(*args, scale=scale),
            lambda: gla_cuda.gla_chunk_plain(*args, scale=scale), 5)
        o_k, s_k = gla_cuda.gla_chunk(*args, scale=scale)
    fwd_work = (nbytes(*args, o_k, s_k), plain_qkv_flops(b, h, t, dk, dv))
    note_shape("gla_chunk", f"training forward b{b} {head} t{t}", fwd_ms, fwd_plain_ms, *fwd_work,
               io)
    if io == bf:
        time_fwd_routes(torch, gla_cuda, False, args, None, scale,
                        f"training forward b{b} {head} t{t}", fwd_work, iters=5)
    routes = ("recurrent", "chunked") if io == bf else ("recurrent",)
    plain_both = lambda: chunk_grads(torch, gla_cuda.gla_chunk_plain, x, do, dsf, scale, True)
    ms, plain = {r: [] for r in routes}, []
    for which in ("plain", *routes, *reversed(routes), "plain"):
        if which == "plain":  # autograd's backward is not captured in a graph: eager
            plain.append(eager_ms(plain_both, 3, warmup=1) - fwd_plain_ms)
        else:
            ms[which].append(device_ms(
                lambda: bwd_on_route(gla_cuda, x, do, dsf, scale, True, which), 5))
    print(f"  gla_chunk_bwd {head} device ms: "
          + ", ".join(f"{r} {ms[r]}" for r in routes)
          + f"; plain backward (eager forward and backward on the host's clock, less the plain "
          f"forward) {plain}")
    mean = lambda xs: sum(xs) / len(xs)
    planned = gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)
    work = (*bwd_work(x, do, dsf, got), io)
    label = f"b{b} {head} t{t} IO {dtype_name(io)} scale {scale:g}"
    if io == bf:
        require(mean(ms["chunked"]) < mean(ms["recurrent"]),
                f"gla_chunk_bwd {label}: the chunked route is not faster: {ms}")
        record(summary, "gla_chunk_bwd", worst, mean(ms[planned]), mean(plain), *work)
        note_shape("gla_chunk_bwd", f"{label}, recurrent route", mean(ms["recurrent"]),
                   None, *work)
        print(f"  gla_chunk_bwd {label}: chunked route {mean(ms['chunked']) * 1e3:.1f} us a "
              f"call, recurrent body {mean(ms['recurrent']) * 1e3:.1f} us")
    else:
        note_shape("gla_chunk_bwd", label, mean(ms[planned]), mean(plain), *work)
    for route in routes:
        scratch = gla_cuda.chunk_bwd_scratch_bytes(b, h, t, dk, dv, route)
        print(f"  scratch of one {route} backward call: {scratch} bytes ({scratch / 1e6:.1f} MB)")
    bwd = lambda: bwd_on_route(gla_cuda, x, do, dsf, scale, True, planned)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base - nbytes(*first.values())
    second = bwd()
    torch.cuda.synchronize()
    require(first.keys() == second.keys()
            and all(torch.equal(first[n], second[n]) for n in first),
            f"gla_chunk_bwd {label}: other bits on a second call")
    print(f"  gla_chunk_bwd {label}, {planned} route: equal bits on a second call; allocator "
          f"peak beside the outputs {peak / 1e6:.1f} MB")
    profiled(torch, lambda: [bwd() for _ in range(3)], f"3 calls of gla_chunk_bwd {label}",
             top=8)


def chunk_bwd_kernel_phase(torch, gla_cuda, summary):
    """gla_chunk's forward and hand-written backward against the plain
    version and autograd through it at the training shapes: b8, t 512, 317
    and 128, with an f32, a bf16 and no initial state; simple-GLA's heads
    (bf16 IO: the backward on both routes, and the chunked one against its
    plain decomposition) and Mamba-2's (f32 IO, scale 1.0); simple-GLA's
    also at the tuning batch (b2) and under adversarial gates. Then the
    backward's route sweep, and times at t512 without an initial state
    (what training runs); the summary takes simple-GLA's."""
    bf, f32 = torch.bfloat16, torch.float32
    simple = (*SIMPLE_HEAD, bf, SIMPLE_HEAD[1] ** -0.5)
    mamba = (*MAMBA_HEAD, f32, 1.0)
    timed = []
    for h, dk, dv, io, scale in (simple, mamba):
        for st in (f32, bf, None):
            for t in TRAIN_T:
                shape = (TRAIN_BATCH, h, t, dk, dv, io, st, scale)
                result = hold_chunk(torch, gla_cuda, shape, need_ds0=True)
                if st is None and t == TRAIN_T[0]:
                    timed.append((shape, result))
    h, dk, dv, io, scale = simple
    for st in (f32, bf, None):
        hold_chunk(torch, gla_cuda, (TUNE_BATCH, h, TRAIN_T[0], dk, dv, io, st, scale),
                   need_ds0=True)
    hold_chunk(torch, gla_cuda, (TRAIN_BATCH, h, TRAIN_T[0], dk, dv, io, None, scale),
               need_ds0=True, adversarial=True)
    bwd_route_sweep(torch, gla_cuda)
    for shape, result in timed:
        time_chunk_bwd(torch, gla_cuda, summary, shape, *result)
    reset_counts()  # the kernel phases' launches are no path's


def hold_decode(torch, gla_cuda, name, shape, summary=None):
    """The classic step ``name`` at ``shape`` = (b, h, dk, dv, IO dtype,
    state dtype) on every route (hold_decode_routes); the public wrapper on
    the route its plan gives (decode_plan), counted under it, against the plain
    version; the planned route and the one it is timed against (decode_pair)
    timed on a rotation of cold states (100 MB) beside the bound, the
    wrapper also beside the plain version: into the summary at
    ``summary``'s shape, else a further shape."""
    b, h, dk, dv, io, st = shape
    steps, work = hold_decode_routes(torch, gla_cuda, name, shape, seed=500 + b + h)
    wrapper, plain, _, _ = decode_fns(gla_cuda, name)
    args, s0 = decode_case(torch, name, shape, seed=500 + b + h)
    route = decode_plan(gla_cuda, name, shape)
    before = dict(wrapper.routes)
    out, ref = wrapper(*args, s0.clone()), plain(*args, s0)
    torch.cuda.synchronize()
    require(wrapper.routes == {**before, route: before[route] + 1},
            f"{name}: not launched on the planned {route} route")
    tag = decode_tag(name, shape)
    print(f"{tag}, the public wrapper ({route} route):")
    err_o = hold_leaf("o", out[0], ref[0], TOL_BF16 if io == torch.bfloat16 else TOL_F32)
    ms = time_routes(steps)[0]
    states = cold_pool(s0)
    wrapper_ms, plain_ms = timed_pair(tag, lambda: wrapper(*args, states()),
                                      lambda: plain(*args, states()), 50)
    other = decode_pair(gla_cuda, name, shape)[1]
    print(f"  {route} (planned) {ms[route] * 1e3:.3f} us, {other} {ms[other] * 1e3:.3f} us "
          f"(medians of {2 * ROUTE_TURNS} in turns)")
    if summary is not None:
        record(summary, name, err_o, wrapper_ms, plain_ms, *work, io)
    else:
        note_shape(name, tag.split(" ", 1)[1], wrapper_ms, plain_ms, *work, io)
    note_shape(name, f"{tag.split(' ', 1)[1]} {other} route", ms[other], None, *work, io)


def decode_kernel_phase(torch, gla_cuda, summary):
    """The two classic steps on both routes against their plain versions
    (hold_decode), timed on cold states: gla_decode_conv at the flagship's
    head at b64 (its b8 and b1 rows come from kernel_phase), gla_decode
    at b1, b8 and b64 for simple-GLA's heads (bf16 IO) and at b8 for
    Mamba-2's (f32 IO), with bf16 and f32 states. The summary takes
    gla_decode at b8 simple-GLA with its f32 state (what the driven path
    runs)."""
    bf, f32 = torch.bfloat16, torch.float32
    hold_decode(torch, gla_cuda, "gla_decode_conv", (64, H, DK, DV, bf, bf))
    for b, (h, dk, dv), io in [(b, SIMPLE_HEAD, bf) for b in (1, BATCH, 64)] + [
            (BATCH, MAMBA_HEAD, f32)]:
        for st in (bf, f32):
            main = (b, h, io, st) == (BATCH, SIMPLE_HEAD[0], bf, f32)
            hold_decode(torch, gla_cuda, "gla_decode", (b, h, dk, dv, io, st),
                        summary=summary if main else None)
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
    live = ("h", "conv") if cfg.backbone.kind in ("mamba", "mamba2") else ("s",)
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
    (gla_chunk and gla_decode, or RWKV6's two; Mamba's mamba_scan and None:
    its decode token is plain tensor code, no kernel): 8 requests (32 text tokens, a 150-code
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
    expect_launches(launches, **{chunk: N_GLA_LAYERS},
                    **({decode: N_GLA_LAYERS * steps} if decode else {}))
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
    """DecodeServer on simple-GLA without convs (or RWKV6, or Mamba): 8
    requests, each four decode chunks past its prompt, through 8 slots in
    classic mode (prefill chunks all on ``chunk``, tokens on ``decode``, or
    on no kernel with ``decode`` None), launch counts against the formula."""
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    reqs = [(text, prompt, (1 if prompt is None else 1 + prompt.shape[1]) + 4 * WINDOW)
            for text, prompt, _ in serving_requests(np, cfg)[:SERVE_CLASSIC_REQUESTS]]
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
    expect_launches(launches, **{chunk: N_GLA_LAYERS * n_prefill},
                    **({decode: N_GLA_LAYERS * WINDOW * n_chunks} if decode else {}))
    for (_, _, max_len), c in zip(reqs, (done[r] for r in sorted(done))):
        require(c.tokens.shape == (c.length, cfg.n_quant) and c.length <= max_len
                and (c.stopped or c.length == max_len), f"request {c.rid}: length {c.length}")
        require(int(c.tokens.min()) >= 0 and int(c.tokens.max()) < model.n_target_vocab,
                f"request {c.rid}: tokens out of range")
    report_chunk_times("classic", len(reqs), chunk_ms, card_line)
    return launches


@contextlib.contextmanager
def forced_bwd_route(ops, plan, route):
    """Within the block every launch of the backward whose plan is ``plan``
    (a function of the module ``ops``: gla_cuda.gla_chunk_bwd_plan,
    rwkv6_cuda.rwkv6_chunk_bwd_plan), the public wrapper's under autograd
    included, takes ``route``: the plan, which the wrapper's launcher asks,
    answers it."""
    planned = getattr(ops, plan)
    setattr(ops, plan, lambda *shape: route)
    try:
        yield
    finally:
        setattr(ops, plan, planned)


def bwd_route_grad_check(torch, gla_cuda, cfg):
    """simple-GLA's parameter gradients in bf16 compute on a batch of 2,
    with every gla_chunk_bwd launch on its planned route (chunked) against
    every one forced onto the recurrent body: the forwards launch the same
    kernels on both sides, so the loss is the same bits and the gradients
    part by the backward's routes alone; each leaf within TOL_PARAM_GRAD of
    its own max|recurrent|, the leaves zero in exact arithmetic left out
    (zero_gradient_mask). The model is built afresh from seed 0, as the
    training phase's f32 check copy is: after the five train steps four
    leaves of the pos_net carry gradients of 1e-8 to 1e-6, which two
    f32-accurate backwards (the recurrent kernel and autograd through the
    plain version) already put 34-42% apart in bf16 compute
    (scripts/torch_bwd_grad_floor.py; PERF.md §6). Returns the
    launches of the planned run."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.train.harness import batch_to_device

    model = build_model(cfg, device=DEVICE, seed=0)
    model.eval()
    small = batch_to_device(check_batch(cfg), DEVICE)
    reset_counts()
    loss_c, grads_c = model_grads(torch, model, small)
    launches = read_counts()
    expect_launches(launches, gla_chunk=N_GLA_LAYERS, gla_chunk_bwd=N_GLA_LAYERS)
    expect_chunked_route(gla_cuda, "gla_chunk_bwd", launches)
    require(gla_cuda.gla_chunk_bwd.routes["chunked"] == N_GLA_LAYERS,
            f"bf16 backward routes {gla_cuda.gla_chunk_bwd.routes}")
    reset_counts()
    with forced_bwd_route(gla_cuda, "gla_chunk_bwd_plan", "recurrent"):
        loss_r, grads_r = model_grads(torch, model, small)
    require(gla_cuda.gla_chunk_bwd.routes == {"recurrent": N_GLA_LAYERS, "chunked": 0},
            f"forced backward routes {gla_cuda.gla_chunk_bwd.routes}")
    reset_counts()
    torch.cuda.synchronize()
    print(f"{cfg.backbone.kind} ({model.dtype} compute, seed 0) parameter gradients, batch of 2 "
          f"(t {small['y_mask'].shape[1]}): every backward on the chunked route vs every one on "
          f"the recurrent body; loss {loss_c!r} vs {loss_r!r}")
    require(loss_c == loss_r, "the forwards of the two runs differ")
    check_grads("parameter gradients, chunked backward vs recurrent backward", grads_c, grads_r,
                TOL_PARAM_GRAD, worst=6, named=("gk_proj",),
                skip=lambda leaf: zero_gradient_mask(torch, leaf, grads_r[leaf]))
    del model, grads_c, grads_r
    torch.cuda.empty_cache()
    return launches


def check_batch(cfg):
    """The batch of 2 (synthetic, seed 1) on which the route checks take
    parameter gradients, on the host."""
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches

    return next(synthetic_tts_batches(
        batch_size=2, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook, min_audio_len=MIN_AUDIO,
        max_audio_len=MAX_AUDIO, seed=1))


def rwkv6_layer_route_grad_check(torch, cfg, prepare):
    """RWKV6's parameter gradients in bf16 compute on a batch of 2 with the
    backward of one layer at a time on the chunked route and every other
    layer's on the recurrent body, against every backward on the recurrent
    body: one forward (the kernels on their planned routes), then for each
    of the 25 RWKV6 layers autograd of the loss w.r.t. that layer's
    parameters, which runs the backward of the layers above it (recurrent)
    and of the layer itself (chunked: the launch whose bonus u is the
    layer's time_faaaa). The gradient that reaches the layer is then the
    same bits on both sides, so its parameters' gradients part by its own
    backward's route alone; each leaf within TOL_PARAM_GRAD of its own
    max|recurrent| (zero_gradient_mask's leaves left out), finite and
    non-zero, one chunked launch counted per layer. With every layer's
    backward chunked at once the lower layers' gradients part from the
    recurrent run's by far more, as they do between any two f32-accurate
    backwards in bf16 compute (autograd through the plain version in f32
    against the recurrent kernel: up to 48% of a leaf's max,
    scripts/torch_bwd_grad_floor.py --kind rwkv6; PERF.md §6), so that
    comparison cannot resolve TOL_PARAM_GRAD; it is printed here, its worst
    leaves and its count over TOL_PARAM_GRAD, beside the launches of its
    run. Returns the launches of the every-layer chunked run."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.models.rwkv6 import RWKV6Attention
    from lina_speech_tpu_torch.ops import gla_cuda, rwkv6_cuda
    from lina_speech_tpu_torch.train.harness import batch_to_device

    model = build_model(cfg, device=DEVICE, seed=0)
    prepare(model)
    model.eval()
    small = batch_to_device(check_batch(cfg), DEVICE)
    reset_counts()
    _, grads_c = model_grads(torch, model, small)
    launches = read_counts()
    expect_launches(launches, rwkv6_chunk=N_GLA_LAYERS, rwkv6_chunk_bwd=N_GLA_LAYERS)
    expect_chunked_route(gla_cuda, "rwkv6_chunk_bwd", launches)
    require(rwkv6_cuda.rwkv6_chunk_bwd.routes["chunked"] == N_GLA_LAYERS,
            f"bf16 backward routes {rwkv6_cuda.rwkv6_chunk_bwd.routes}")
    layers = [(n, m) for n, m in model.named_modules() if isinstance(m, RWKV6Attention)]
    params = dict(model.named_parameters())
    launch = rwkv6_cuda._chunk_bwd_launch
    chunked_u = []  # the data pointer of the one layer's bonus whose backward is chunked

    def routed(r, k, v, w, u, *rest, route=None):
        return launch(r, k, v, w, u, *rest,
                      route="chunked" if u.data_ptr() in chunked_u else "recurrent")

    reset_counts()
    loss = model(small["text_token"], small["audio_token"], small["encoder_mask"],
                 small["crossatt_mask"], logits_mask=small["y_mask"])[1]
    rwkv6_cuda._chunk_bwd_launch = routed
    try:
        got = torch.autograd.grad(loss, list(params.values()), retain_graph=True,
                                  allow_unused=True)
        grads_r = {n: g for n, g in zip(params, got) if g is not None}
        require(rwkv6_cuda.rwkv6_chunk_bwd.routes == {"recurrent": N_GLA_LAYERS, "chunked": 0},
                f"forced backward routes {rwkv6_cuda.rwkv6_chunk_bwd.routes}")
        print(f"rwkv6 (bf16 compute, seed 0) parameter gradients, batch of 2 (t "
              f"{small['y_mask'].shape[1]}), one layer's backward on the chunked route at a time, "
              f"every other layer's on the recurrent body, against every backward on the "
              f"recurrent body (each leaf within {TOL_PARAM_GRAD:.1e} of its own max|ref|):")
        worst = []
        for name, layer in layers:
            own = [n for n in params if n.startswith(name + ".") and n in grads_r]
            chunked_u[:] = [layer.time_faaaa.data_ptr()]
            before = dict(rwkv6_cuda.rwkv6_chunk_bwd.routes)
            got = torch.autograd.grad(loss, [params[n] for n in own], retain_graph=True)
            require(rwkv6_cuda.rwkv6_chunk_bwd.routes["chunked"] == before["chunked"] + 1,
                    f"{name}: its backward did not take the chunked route once")
            mask = lambda leaf: zero_gradient_mask(torch, leaf, grads_r[leaf])
            worst.append((check_grads(f"{name}, its backward chunked", dict(zip(own, got)),
                                      {n: grads_r[n] for n in own}, TOL_PARAM_GRAD, skip=mask,
                                      worst=2), name))
        print(f"  {len(worst)} layers ok; the worst: " + ", ".join(
            f"{name} {share:.3e}" for share, name in sorted(worst, reverse=True)[:4]))
    finally:
        rwkv6_cuda._chunk_bwd_launch = launch
        chunked_u.clear()
    del loss
    rows = []
    for leaf, ref in grads_r.items():
        mask = zero_gradient_mask(torch, leaf, ref)
        if bool(mask.all()):
            continue
        a, r = grads_c[leaf].float()[~mask], ref.float()[~mask]
        rows.append((float((a - r).abs().max()) / float(r.abs().max()), leaf))
    rows.sort(reverse=True)
    over = sum(share > TOL_PARAM_GRAD for share, _ in rows)
    print(f"  every layer's backward chunked at once vs every one recurrent (not held: below the "
          f"bf16 floor): {over} of {len(rows)} leaves over {TOL_PARAM_GRAD:g}; worst "
          + ", ".join(f"{leaf} {share:.3e}" for share, leaf in rows[:4]))
    del model, grads_c, grads_r
    reset_counts()
    torch.cuda.empty_cache()
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
    add_launches(total, bwd_route_grad_check(torch, gla_cuda, cfg))
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
    backward and the two classic steps on is held against the plain version
    now (the classic steps on both routes), unless a kernel phase held it
    already."""
    fwd = sorted(GLA_LAUNCHED["gla_chunk"] - CHUNK_HELD, key=str)
    bwd = sorted(GLA_LAUNCHED["gla_chunk_bwd"] - CHUNK_BWD_HELD, key=str)
    # (the holds below launch the kernels too, but read no counts: GLA_LAUNCHED
    # keeps only what the driven paths launched)
    dec = {name: sorted(GLA_LAUNCHED[name] - DECODE_HELD[name], key=str) for name in DECODE_HELD}
    print(f"the driven paths launched gla_chunk on {len(GLA_LAUNCHED['gla_chunk'])} shapes "
          f"({len(fwd)} not held yet), its backward on {len(GLA_LAUNCHED['gla_chunk_bwd'])} "
          f"({len(bwd)}), " + ", ".join(f"{name} on {len(GLA_LAUNCHED[name])} ({len(dec[name])})"
                                        for name in dec))
    require(all(GLA_LAUNCHED.values()), f"a kernel launched on no shape: {GLA_LAUNCHED}")
    for shape in bwd:
        hold_chunk(torch, gla_cuda, shape[:-1], need_ds0=shape[-1])
    for shape in sorted(GLA_LAUNCHED["gla_chunk"] - CHUNK_HELD, key=str):
        hold_chunk(torch, gla_cuda, shape[:-1])
    for name, shapes in dec.items():
        for shape in shapes:
            hold_decode_routes(torch, gla_cuda, name, shape[:-1], seed=850)
    require(GLA_LAUNCHED["gla_chunk"] <= CHUNK_HELD
            and GLA_LAUNCHED["gla_chunk_bwd"] <= CHUNK_BWD_HELD
            and all(GLA_LAUNCHED[name] <= DECODE_HELD[name] for name in DECODE_HELD),
            "launched but not held")


def gap_phase(torch, gla_cuda, card_line):
    """launches x (time - bound) of the two forward kernels and of
    gla_chunk's backward over the main paths (and of the three decode steps,
    lazy_gap_phase and decode_gap_phase): every shape a main path
    launched them on, weighted by its launch count (GAP_SHAPE_COUNTS),
    timed on the route it took and on the recurrent body, beside the
    shape's bound; where the backward's plan takes the chunked route it
    must be the faster. Prints each shape and the sums; returns {kernel: sum
    in ms on the routes taken}."""
    bf = torch.bfloat16
    sums = {}
    for name in ("gla_chunk_conv", "gla_chunk", "gla_chunk_bwd"):
        counts = GAP_SHAPE_COUNTS[name]
        conv, bwd = name == "gla_chunk_conv", name == "gla_chunk_bwd"
        fn = fwd_fns(gla_cuda, conv)[0]
        total = {"taken": 0.0, "recurrent": 0.0}
        print(f"{name}: launches x (time - bound) over {sum(counts.values())} main-path launches "
              f"on {len(counts)} shapes (device us; the planned route, the recurrent body, the "
              f"bound):")
        for shape, n in sorted(counts.items(), key=str):
            if conv:
                (b, t, st, route), h, dk, dv, io, scale = shape, H, DK, DV, bf, None
                x = kernel_inputs(torch, b, t, st, seed=700 + t)
                flops = scan_flops(b, t, True)
            elif bwd:
                b, h, t, dk, dv, io, st, scale, need_ds0 = shape
                route = gla_cuda.gla_chunk_bwd_plan(io, b, h, t, dv)
                x, do, dsf = bwd_inputs(torch, b, h, t, dk, dv, io, st, seed=700 + t)
            else:
                b, h, t, dk, dv, io, st, scale, route = shape
                x = qkv_inputs(torch, b, h, t, dk, dv, io, st, seed=700 + t)
                flops = plain_qkv_flops(b, h, t, dk, dv)
            if bwd:
                got = bwd_on_route(gla_cuda, x, do, dsf, scale, need_ds0, route)
                bound_ms = roofline(*bwd_work(x, do, dsf, got), io)[0]
                ms = time_bwd_routes(torch, gla_cuda, x, do, dsf, scale,
                                     f"b{b} {head_name(h, dk, dv)} t{t}", need_ds0=need_ds0)
            else:
                args = fwd_args(x, conv)
                with torch.no_grad():
                    o, sf = fn(*args, initial_state=x["s0"], scale=scale)
                    bound_ms = roofline(nbytes(*args, x["s0"], o, sf), flops, io)[0]
                    ms = {r: device_ms(
                        lambda: fwd_on_route(gla_cuda, conv, args, x["s0"], scale, r), 5)
                        for r in sorted({route, "recurrent"})}
            total["taken"] += n * (ms[route] - bound_ms)
            total["recurrent"] += n * (ms["recurrent"] - bound_ms)
            print(f"  {shape}: {n} launches; {route} {ms[route] * 1e3:.2f}, recurrent "
                  f"{ms['recurrent'] * 1e3:.2f}, bound {bound_ms * 1e3:.3f}")
        print(f"  {name}: sum of launches x (time - bound) {total['taken']:.3f} ms on the routes "
              f"taken; {total['recurrent']:.3f} ms had every launch taken the recurrent body "
              f"[{card_line}]")
        sums[name] = total["taken"]
    sums.update(lazy_gap_phase(torch, gla_cuda, card_line))
    sums.update(decode_gap_phase(torch, gla_cuda, card_line))
    sums.update(fold_gap_phase(torch, gla_cuda, card_line))
    return sums


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


def rwkv6_on_route(rwkv6_cuda, x, route):
    """rwkv6_chunk on the inputs ``x`` through the wrapper's launcher, forced
    onto ``route`` (the public wrapper takes the plan's)."""
    return rwkv6_cuda._chunk_launch(*(x[n] for n in RWKV6_LEAVES[:5]), x["s0"], route=route)


def rwkv6_routes(torch, io):
    """The routes rwkv6_chunk has for IO dtype ``io``."""
    return ("recurrent", "chunked") if io == torch.bfloat16 else ("recurrent",)


def hold_rwkv6_chunk(torch, rwkv6_cuda, shape, need_ds0=None, route=None):
    """rwkv6_chunk at ``shape`` = (b, h, t, dk, dv, IO dtype, initial-state
    dtype or None) against its plain version: with ``need_ds0`` None the
    inference forward (o, final state) forced onto ``route`` (None: every
    route its IO dtype has), the chunked route also against its own plain
    version (the same decomposition with tensors); otherwise as training
    calls it (autograd recording: the forward kernel and the hand-written
    backward, each on its planned route) against autograd through the plain
    version, o, the final state and every gradient leaf (dr, dk, dv, dw, du,
    and ds0 where wanted), and with bf16 IO the backward on both routes
    (hold_rwkv6_bwd_routes). Each tensor within a share of its own
    max|plain|, finite and non-zero (a NaN fails). Returns (inputs, do, dsf,
    gradients, worst gradient share); the last four None for the inference
    forward."""
    b, h, t, dk, dv, io, st = shape
    x = rwkv6_inputs(torch, b, h, t, dk, dv, io, st, seed=700 + t + b)
    name = (f"rwkv6_chunk b{b} {head_name(h, dk, dv)} t{t} IO {dtype_name(io)} "
            f"initial state {dtype_name(st)}")
    tol = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    tol_s = TOL_BF16 if torch.bfloat16 in (io, st) else TOL_F32
    args = tuple(x[n] for n in RWKV6_LEAVES[:5])
    if need_ds0 is None:
        with torch.no_grad():
            o_p, s_p = rwkv6_cuda.rwkv6_chunk_plain(*args, initial_state=x["s0"])
            fn = rwkv6_cuda.rwkv6_chunk
            for r in (route,) if route else rwkv6_routes(torch, io):
                before, routes = fn.launches, dict(fn.routes)
                o_k, s_k = rwkv6_on_route(rwkv6_cuda, x, r)
                torch.cuda.synchronize()
                routes[r] += 1
                require(fn.launches == before + 1 and fn.routes == routes,
                        f"{name}: not launched on the {r} route")
                print(f"{name}, {r} route:")
                require(o_k.dtype == io and s_k.dtype == (st or torch.float32),
                        "rwkv6_chunk output dtypes")
                hold_own_max("o", o_k, o_p, tol)
                hold_own_max("final state", s_k, s_p, tol_s)
                if r == "chunked":
                    o_c, s_c = rwkv6_cuda.rwkv6_chunk_chunked_plain(*args, initial_state=x["s0"])
                    hold_own_max("o, vs the chunked route's plain version", o_k, o_c, tol)
                    hold_own_max("final state, vs the chunked route's plain version", s_k, s_c,
                                 TOL_BF16 if st == torch.bfloat16 else TOL_F32)
                RWKV6_HELD["rwkv6_chunk"].add((*shape, r))
        return x, None, None, None, None
    before = rwkv6_cuda.launch_counts()
    bwd_routes = dict(rwkv6_cuda.rwkv6_chunk_bwd.routes)
    do, dsf = rwkv6_cotangents(torch, x, seed=t)
    o_k, s_k, got = rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk, x, do, dsf, need_ds0)
    o_p, s_p, ref = rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk_plain, x, do, dsf, need_ds0)
    name += "" if need_ds0 or st is None else ", no ds0"
    after = rwkv6_cuda.launch_counts()
    torch.cuda.synchronize()
    require(after["rwkv6_chunk"] == before["rwkv6_chunk"] + 1
            and after["rwkv6_chunk_bwd"] == before["rwkv6_chunk_bwd"] + 1,
            f"{name}: not launched through the kernels")
    planned = rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, h, t, dv)
    bwd_routes[planned] += 1
    require(rwkv6_cuda.rwkv6_chunk_bwd.routes == bwd_routes,
            f"{name}: the backward did not take its planned route: "
            f"{rwkv6_cuda.rwkv6_chunk_bwd.routes}")
    route = rwkv6_cuda.rwkv6_chunk_fwd_plan(io, b, h, t, dv)
    print(f"{name}, forward ({route} route, the plan's):")
    require(o_k.dtype == io and s_k.dtype == (st or torch.float32), "rwkv6_chunk output dtypes")
    hold_own_max("o", o_k, o_p, tol)
    hold_own_max("final state", s_k, s_p, tol_s)
    RWKV6_HELD["rwkv6_chunk"].add((*shape, route))
    tol_g = TOL_GRAD if torch.bfloat16 in (io, st) else TOL_F32
    worst = check_grads(f"{name}, backward ({planned} route, the plan's)", got, ref, tol_g)
    held = need_ds0 and st is not None
    RWKV6_HELD["rwkv6_chunk_bwd"].add((*shape, held, planned))
    if io == torch.bfloat16:
        hold_rwkv6_bwd_routes(torch, rwkv6_cuda, name, x, do, dsf, need_ds0, ref, tol_g, planned,
                              got)
        RWKV6_HELD["rwkv6_chunk_bwd"].update((*shape, held, r) for r in rwkv6_routes(torch, io))
    return x, do, dsf, got, worst


def rwkv6_cotangents(torch, x, seed):
    """do (the IO dtype) and dsf (the initial state's dtype, f32 without
    one) for the RWKV6 inputs ``x``, from ``seed``."""
    b, h, t, dk = x["r"].shape
    dv = x["v"].shape[-1]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    do = torch.randn(b, h, t, dv, generator=g, device=DEVICE).to(x["r"].dtype)
    dsf = torch.randn(b, h, dk, dv, generator=g, device=DEVICE).to(
        torch.float32 if x["s0"] is None else x["s0"].dtype)
    return do, dsf


def rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, need_ds0, route):
    """rwkv6_chunk_bwd on ``x`` through the wrapper's launcher, forced onto
    ``route`` (the public wrapper takes the plan's); returns {leaf:
    gradient} of the leaves that came back."""
    out = rwkv6_cuda._chunk_bwd_launch(*(x[n] for n in RWKV6_LEAVES), do, dsf, need_ds0, route)
    return {n: g for n, g in zip(RWKV6_LEAVES, out) if g is not None}


def hold_rwkv6_bwd_routes(torch, rwkv6_cuda, name, x, do, dsf, need_ds0, ref, tol, planned,
                          got):
    """rwkv6_chunk_bwd with bf16 IO on the route other than ``planned``
    (whose gradients ``got`` autograd's launch gave) against ``ref``, the
    gradients of autograd through the plain version, each leaf within
    ``tol`` of its own max|plain|, finite and non-zero; then the chunked
    route's against rwkv6_chunk_bwd_chunked_plain, the same decomposition
    with tensors and the kernels' bf16 rounding points, within TOL_BF16."""
    other = "recurrent" if planned == "chunked" else "chunked"
    forced = rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, need_ds0, other)
    torch.cuda.synchronize()
    check_grads(f"{name}, backward forced onto the {other} route", forced, ref, tol)
    chunked = got if planned == "chunked" else forced
    plain = rwkv6_cuda.rwkv6_chunk_bwd_chunked_plain(
        *(x[n] for n in RWKV6_LEAVES), do, dsf, operand_dtype=torch.bfloat16)
    plain = {n: g for n, g in zip(RWKV6_LEAVES, plain) if n in chunked}
    check_grads(f"{name}, chunked backward vs its plain decomposition", chunked, plain, TOL_BF16)


def rwkv6_route_steps(rwkv6_cuda, x):
    """{route: one no-grad call of rwkv6_chunk on ``x`` forced onto it} for
    time_routes, every route the IO dtype has."""
    import torch

    def step(route):
        with torch.no_grad():
            return rwkv6_on_route(rwkv6_cuda, x, route)

    return {r: (lambda r=r: step(r)) for r in rwkv6_routes(torch, x["r"].dtype)}


def rwkv6_work(x):
    """(bytes, operations) of one rwkv6_chunk call on ``x``: every input
    read and every output (o in the IO dtype, the final state in the initial
    state's, f32 without one) written once."""
    b, h, t, dk = x["r"].shape
    dv = x["v"].shape[-1]
    out = b * h * (t * dv * x["r"].element_size()
                   + dk * dv * (4 if x["s0"] is None else x["s0"].element_size()))
    return (nbytes(*(x[n] for n in RWKV6_LEAVES[:5]), x["s0"]) + out,
            rwkv6_flops(b, h, t, dk, dv))


def rwkv6_bwd_work(x, do, dsf, got):
    """(bytes, operations) of one rwkv6_chunk_bwd call: its inputs and
    outputs, and the recurrence's backward operations."""
    b, h, t, dk = x["r"].shape
    return (nbytes(*(x[n] for n in RWKV6_LEAVES), do, dsf, *got.values()),
            rwkv6_flops(b, h, t, dk, x["v"].shape[-1], backward=True))


def rwkv6_bwd_route_steps(rwkv6_cuda, x, do, dsf, need_ds0=True):
    """{route: one call of rwkv6_chunk_bwd on ``x`` forced onto it} for
    time_routes, every route the IO dtype has."""
    import torch

    return {r: (lambda r=r: rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, need_ds0, r))
            for r in rwkv6_routes(torch, x["r"].dtype)}


def time_rwkv6_bwd(torch, rwkv6_cuda, summary, x, do, dsf, got, worst, fwd_plain_ms, card_line):
    """rwkv6_chunk_bwd at the training shape (b8 t512, no initial state):
    both routes timed in turns (median of six, the planned one at most
    SWEEP_MARGIN slower, retimed on a miss) beside the bound, the plain
    version's eager time and each route's scratch; the planned route is the
    summary's row, the other a further shape; a profile of three calls by
    kernel."""
    b, h, t, dk = x["r"].shape
    dv, io = x["v"].shape[-1], x["r"].dtype
    planned = rwkv6_cuda.rwkv6_chunk_bwd_plan(io, b, h, t, dv)
    label = f"rwkv6_chunk_bwd b{b} {head_name(h, dk, dv)} t{t} IO {dtype_name(io)}"
    ms, times = planned_route_times(rwkv6_bwd_route_steps(rwkv6_cuda, x, do, dsf), planned, label)
    plain_both = lambda: rwkv6_grads(torch, rwkv6_cuda.rwkv6_chunk_plain, x, do, dsf, False)
    plain = [eager_ms(plain_both, 3, warmup=1) - fwd_plain_ms for _ in range(2)]
    work = (*rwkv6_bwd_work(x, do, dsf, got), io)
    bound_ms = roofline(*work)[0]
    print(f"  {label} device ms, in turns [{card_line}]: "
          + ", ".join(f"{r} {times[r]}" for r in times)
          + f"; plain backward (eager forward and backward on the host's clock, less the plain "
          f"forward) {plain}")
    # max_abs_err: the largest error of a leaf as a share of its max|plain|
    record(summary, "rwkv6_chunk_bwd", worst, ms[planned], sum(plain) / len(plain), *work)
    for r in ms:
        if r != planned:
            note_shape("rwkv6_chunk_bwd", f"b{b} t{t} initial state none, {r} route (in turns)",
                       ms[r], None, *work)
    print(f"  {label}: " + ", ".join(f"{r} {ms[r] * 1e3:.1f} us" for r in ms)
          + f" (median of {2 * ROUTE_TURNS} in turns), bound {bound_ms * 1e3:.1f} us; the plan "
          f"takes {planned}")
    for r in ms:
        scratch = rwkv6_cuda.chunk_bwd_scratch_bytes(b, h, t, dk, dv, r)
        print(f"  scratch of one {r} backward call: {scratch} bytes ({scratch / 1e6:.1f} MB)")
    bwd = lambda: rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, False, planned)
    profiled(torch, lambda: [bwd() for _ in range(3)],
             f"3 calls of rwkv6_chunk_bwd b{b} t{t}, {planned} route", top=8)


def rwkv6_kernel_phase(torch, rwkv6_cuda, summary, card_line):
    """The three RWKV6 kernels against their plain versions at the
    flagship-width RWKV6 heads (h4 dk256 dv256, bf16 IO, f32 w and u):
    the forward at b8 t151 (generate's prefill), b1 t128 and b1 t1 (server
    prefill chunks), with an f32 and with no initial state, on both routes;
    forward and backward at b8 t512 (training) with and without one, all six
    gradient leaves, the backward on both routes (each twice: equal bits);
    the decode token at b1, b8 and b64 with f32 and bf16 states on cold
    states. The forward's two routes timed in turns at b8 t512 (no initial
    state, the training forward), b8 t151 and b1 t128 (f32 initial state),
    the backward's at b8 t512 (time_rwkv6_bwd); every time beside its
    bound. The summary takes the
    forward at b8 t151 with an f32 state (what generate launches), the
    backward at b8 t512 without one (what training launches) and the decode
    token at b8 with an f32 state. Then the forward's and the backward's
    route sweeps."""
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
            route = rwkv6_cuda.rwkv6_chunk_fwd_plan(bf, b, h, t, dv)
            if (b, st) == (BATCH, f32):
                record(summary, "rwkv6_chunk", max_err(o_k, o_p), ms, plain_ms, *work)
            else:
                note_shape("rwkv6_chunk", f"b{b} t{t} initial state {dtype_name(st)}, {route} "
                           "route (the plan's)", ms, plain_ms, *work)
    t = TRAIN_T[0]
    for st in (f32, None):
        x, do, dsf, got, worst = hold_rwkv6_chunk(torch, rwkv6_cuda,
                                                  (TRAIN_BATCH, h, t, dk, dv, bf, st), True)
        for route in rwkv6_routes(torch, bf):
            first = rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, True, route)
            second = rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, True, route)
            torch.cuda.synchronize()
            require(first.keys() == second.keys()
                    and all(torch.equal(first[n], second[n]) for n in first),
                    f"rwkv6_chunk_bwd b{TRAIN_BATCH} t{t} {dtype_name(st)}, {route} route: other "
                    "bits on a second call")
            print(f"  rwkv6_chunk_bwd b{TRAIN_BATCH} t{t} initial state {dtype_name(st)}, {route} "
                  "route: equal bits on a second call")
        if st is not None:
            continue
        hold_rwkv6_chunk(torch, rwkv6_cuda, (TRAIN_BATCH, h, t, dk, dv, bf, st))
        args = tuple(x[n] for n in RWKV6_LEAVES[:5])
        with torch.no_grad():
            fwd_ms, fwd_plain_ms = timed_pair(
                f"rwkv6_chunk training forward b{TRAIN_BATCH} t{t}",
                lambda: rwkv6_cuda.rwkv6_chunk(*args),
                lambda: rwkv6_cuda.rwkv6_chunk_plain(*args), 5)
            o_k, s_k = rwkv6_cuda.rwkv6_chunk(*args)
        note_shape("rwkv6_chunk", f"training forward b{TRAIN_BATCH} t{t} initial state none, "
                   f"{rwkv6_cuda.rwkv6_chunk_fwd_plan(bf, TRAIN_BATCH, h, t, dv)} route (the "
                   "plan's)", fwd_ms, fwd_plain_ms, nbytes(*args, o_k, s_k),
                   rwkv6_flops(TRAIN_BATCH, h, t, dk, dv), bf)
        profiled(torch, lambda: [rwkv6_on_route(rwkv6_cuda, x, "chunked") for _ in range(3)],
                 f"3 calls of rwkv6_chunk b{TRAIN_BATCH} t{t}, chunked route", top=6)
        time_rwkv6_bwd(torch, rwkv6_cuda, summary, x, do, dsf, got, worst, fwd_plain_ms,
                       card_line)
    print(f"rwkv6_chunk, both routes in turns (device us, median of {2 * ROUTE_TURNS}) "
          f"[{card_line}]:")
    for b, t, st in ((TRAIN_BATCH, TRAIN_T[0], None), (BATCH, T_PROMPT + 1, f32), (1, 128, f32)):
        x = rwkv6_inputs(torch, b, h, t, dk, dv, bf, st, seed=760 + t)
        work = rwkv6_work(x)
        ms, times = time_routes(rwkv6_route_steps(rwkv6_cuda, x))
        print(f"  b{b} t{t} initial state {dtype_name(st)}: " + ", ".join(
            f"{r} {ms[r] * 1e3:.2f} ({[round(v * 1e3, 2) for v in times[r]]})" for r in ms)
            + f"; the plan takes {rwkv6_cuda.rwkv6_chunk_fwd_plan(bf, b, h, t, dv)}")
        for r in ms:
            note_shape("rwkv6_chunk", f"b{b} t{t} initial state {dtype_name(st)}, {r} route "
                       "(in turns)", ms[r], None, *work, bf)
    from lina_speech_tpu_torch.ops import gla_cuda

    for b in (1, BATCH, 64):
        for st in (bf, f32):
            hold_decode(torch, gla_cuda, "rwkv6_decode", (b, h, dk, dv, bf, st),
                        summary=summary if (b, st) == (BATCH, f32) else None)
    rwkv6_route_sweep(torch, rwkv6_cuda, card_line)
    rwkv6_bwd_route_sweep(torch, rwkv6_cuda, card_line)
    reset_counts()  # the kernel phases' launches are no path's


# lengths and batches of rwkv6_chunk's route sweep (h4 dk256 dv256): they
# bracket rwkv6_chunk_fwd_plan's thresholds
RWKV6_SWEEP_T = (16, 32, 48, 64, 96, 128, 192)
RWKV6_SWEEP_B = (1, 2, 4, 8)


def rwkv6_route_sweep(torch, rwkv6_cuda, card_line):
    """rwkv6_chunk's two routes timed in turns at the flagship RWKV6 heads
    (bf16 IO, f32 initial state) over RWKV6_SWEEP_B x RWKV6_SWEEP_T, where
    the plan's thresholds come from: at every point the route
    rwkv6_chunk_fwd_plan picks may be at most SWEEP_MARGIN slower than the
    other by the median of six turns, timed again before a miss fails."""
    h, dk, dv = RWKV6_HEAD
    bf = torch.bfloat16
    print(f"rwkv6_chunk route sweep ({head_name(h, dk, dv)}, bf16 IO, f32 initial state; "
          f"device us, median of {2 * ROUTE_TURNS} in turns) [{card_line}]:")
    for b in RWKV6_SWEEP_B:
        for t in RWKV6_SWEEP_T:
            x = rwkv6_inputs(torch, b, h, t, dk, dv, bf, torch.float32, seed=900 + t)
            plan = rwkv6_cuda.rwkv6_chunk_fwd_plan(bf, b, h, t, dv)
            ms, _ = planned_route_times(rwkv6_route_steps(rwkv6_cuda, x), plan,
                                        f"rwkv6_chunk sweep b{b} t{t}")
            print(f"  b{b} ({b * h} heads) t{t}: recurrent {ms['recurrent'] * 1e3:.2f}, chunked "
                  f"{ms['chunked'] * 1e3:.2f}; planned {plan}")


# lengths and batches of rwkv6_chunk_bwd's route sweep (h4 dk256 dv256): they
# bracket rwkv6_chunk_bwd_plan's threshold and reach the training lengths
RWKV6_BWD_SWEEP_T = (16, 32, 48, 64, 96, 128, 256, 512)


def rwkv6_bwd_route_sweep(torch, rwkv6_cuda, card_line):
    """rwkv6_chunk_bwd's two routes timed in turns at the flagship RWKV6
    heads (bf16 IO, no initial state, as training runs) over RWKV6_SWEEP_B x
    RWKV6_BWD_SWEEP_T, where the plan's threshold comes from: every point
    is timed and printed first (median of six turns); then at every point
    the route rwkv6_chunk_bwd_plan picks may be at most SWEEP_MARGIN slower
    than the other, a point that misses timed again (planned_route_times)
    before the sweep fails on it."""
    h, dk, dv = RWKV6_HEAD
    bf = torch.bfloat16
    print(f"rwkv6_chunk_bwd route sweep ({head_name(h, dk, dv)}, bf16 IO, no initial state; "
          f"device us, median of {2 * ROUTE_TURNS} in turns) [{card_line}]:")
    misses = []
    for b in RWKV6_SWEEP_B:
        for t in RWKV6_BWD_SWEEP_T:
            x = rwkv6_inputs(torch, b, h, t, dk, dv, bf, None, seed=950 + t)
            do, dsf = rwkv6_cotangents(torch, x, seed=951 + t)
            steps = rwkv6_bwd_route_steps(rwkv6_cuda, x, do, dsf, False)
            plan = rwkv6_cuda.rwkv6_chunk_bwd_plan(bf, b, h, t, dv)
            ms, _ = time_routes(steps)
            print(f"  b{b} ({b * h} heads) t{t}: recurrent {ms['recurrent'] * 1e3:.2f}, chunked "
                  f"{ms['chunked'] * 1e3:.2f}; planned {plan}")
            other = "recurrent" if plan == "chunked" else "chunked"
            if ms[plan] > ms[other] * (1 + SWEEP_MARGIN):
                misses.append((b, t, plan, steps))
    for b, t, plan, steps in misses:  # fails here unless a second round clears it
        planned_route_times(steps, plan, f"rwkv6_chunk_bwd sweep b{b} t{t}")


def rwkv6_gap_phase(torch, rwkv6_cuda, card_line):
    """launches x (time - bound) of rwkv6_chunk and of rwkv6_chunk_bwd over
    the RWKV6 main paths: every shape they launched each on, weighted by its
    launch count (GAP_SHAPE_COUNTS), held against the plain version on the
    route it took (launched_rwkv6_shapes_phase), timed here on every route
    its IO dtype has in turns (median of six, retimed on a miss; the route
    taken at most SWEEP_MARGIN slower than the other), beside the shape's
    bound. Prints each shape, the sum on the routes taken and the sum had
    every launch taken the recurrent body; then rwkv6_decode over every
    shape it was launched on, held on both bodies and timed in turns
    (decode_gap_phase: the planned body must be the faster; the sum had
    every launch taken the tile body beside). Returns {kernel: the sum on
    the routes taken}."""
    from lina_speech_tpu_torch.ops import gla_cuda

    sums = decode_gap_phase(torch, gla_cuda, card_line, names=("rwkv6_decode",))
    for name in ("rwkv6_chunk", "rwkv6_chunk_bwd"):
        counts = GAP_SHAPE_COUNTS[name]
        require(counts, f"{name}: the main paths launched it on no shape")
        total = {"taken": 0.0, "recurrent": 0.0}
        print(f"{name}: launches x (time - bound) over {sum(counts.values())} main-path "
              f"launches on {len(counts)} shapes (device us; the route taken, the recurrent body, "
              f"the bound):")
        for shape, n in sorted(counts.items(), key=str):
            b, h, t, dk, dv, io, st = shape[:7]
            route = shape[-1]
            x = rwkv6_inputs(torch, b, h, t, dk, dv, io, st, seed=770 + t)
            if name == "rwkv6_chunk":
                work = rwkv6_work(x)
                steps = rwkv6_route_steps(rwkv6_cuda, x)
            else:
                need_ds0 = shape[7]
                do, dsf = rwkv6_cotangents(torch, x, seed=771 + t)
                got = rwkv6_bwd_on_route(rwkv6_cuda, x, do, dsf, need_ds0, route)
                work = rwkv6_bwd_work(x, do, dsf, got)
                steps = rwkv6_bwd_route_steps(rwkv6_cuda, x, do, dsf, need_ds0)
            bound_ms = roofline(*work, io)[0]
            label = f"{name} b{b} {head_name(h, dk, dv)} t{t} {dtype_name(st)}"
            if len(steps) > 1:
                ms = planned_route_times(steps, route, label)[0]
            else:
                ms = time_routes(steps)[0]
            total["taken"] += n * (ms[route] - bound_ms)
            total["recurrent"] += n * (ms["recurrent"] - bound_ms)
            print(f"  {shape}: {n} launches; {route} {ms[route] * 1e3:.2f}, recurrent "
                  f"{ms['recurrent'] * 1e3:.2f}, bound {bound_ms * 1e3:.3f}")
        print(f"  {name}: sum of launches x (time - bound) {total['taken']:.3f} ms on the routes "
              f"taken; {total['recurrent']:.3f} ms had every launch taken the recurrent body "
              f"[{card_line}]")
        sums[name] = total["taken"]
    return sums


def rwkv6_phase(torch, np, gla_cuda, card_line):
    """RWKV6 at the flagship's width (lina_gla_169m with kind="rwkv6",
    291,117,378 parameters, random weights from seed 0 with the bonus, the
    ddlerp mixes and the decays drawn off their constant inits, bf16
    compute, f32 states): generate_batch for 8 requests (classic loop;
    rwkv6_chunk for the prefill, rwkv6_decode for each token) with the
    kernel path held against the plain path under teacher forcing (in bf16,
    and on a copy built in f32 compute), a
    DecodeServer in classic mode (8 requests, 8 slots) and three train
    steps at b8 (rwkv6_chunk and its backward, every bf16 backward at or
    above its plan's threshold on the chunked route), the kernel path's loss
    and parameter gradients held against the plain path's on a batch of 2
    (on a copy built in f32 compute: its f32 IO takes the recurrent
    backward), and the bf16 model's parameter gradients with one layer's
    backward at a time on the chunked route against every one on the
    recurrent body (rwkv6_layer_route_grad_check). RWKV6 has no lazy window
    and no S0 tuning, as in JAX."""
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
    add_launches(total, rwkv6_layer_route_grad_check(torch, cfg, prepare))
    return total


def launched_rwkv6_shapes_phase(torch, rwkv6_cuda):
    """Every shape the driven RWKV6 paths launched the three RWKV6 kernels
    on is held against the plain version now (rwkv6_chunk on the route it
    took, rwkv6_chunk_bwd on the route it took and, with bf16 IO, the
    other), unless the RWKV6 kernel phase held it already."""
    todo = {n: sorted(RWKV6_LAUNCHED[n] - RWKV6_HELD[n], key=str) for n in RWKV6_LAUNCHED}
    print("the driven RWKV6 paths launched " + ", ".join(
        f"{n} on {len(RWKV6_LAUNCHED[n])} shapes ({len(todo[n])} not held yet)" for n in todo))
    require(all(RWKV6_LAUNCHED.values()), f"an RWKV6 kernel launched on no shape: {RWKV6_LAUNCHED}")
    for shape in todo["rwkv6_chunk_bwd"]:  # (..., need_ds0, route): held on every route
        hold_rwkv6_chunk(torch, rwkv6_cuda, shape[:7], need_ds0=shape[7])
    for shape in sorted(RWKV6_LAUNCHED["rwkv6_chunk"] - RWKV6_HELD["rwkv6_chunk"], key=str):
        hold_rwkv6_chunk(torch, rwkv6_cuda, shape[:-1], route=shape[-1])
    from lina_speech_tpu_torch.ops import gla_cuda

    for shape in todo["rwkv6_decode"]:  # (..., route): held on every route
        hold_decode_routes(torch, gla_cuda, "rwkv6_decode", shape[:6], seed=600 + shape[0])
    require(all(RWKV6_LAUNCHED[n] <= RWKV6_HELD[n] for n in RWKV6_LAUNCHED),
            "RWKV6: launched but not held")


MAMBA_LEAVES = ("x", "dt", "A", "B", "C", "D", "s0")


def mamba_inputs(torch, b, t, io, st, reset, seed):
    """x, B, C in the IO dtype (d 2048, n 16); f32 steps dt =
    softplus(N(-2, 1)), rates A = -U(1, 16) (as perturb_mamba_params_ draws
    exp(A_log)), D ~ U(0.5, 1.5); an initial state of dtype ``st`` (None:
    none); with ``reset`` a reset mask at 5% of the steps (a packed batch's
    segment starts)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    u = lambda *s: torch.rand(*s, generator=g, device=DEVICE)
    d, n = MAMBA_D, MAMBA_N
    return dict(x=r(b, t, d).to(io), dt=torch.nn.functional.softplus(r(b, t, d) - 2.0),
                A=-(1.0 + 15.0 * u(d, n)), B=r(b, t, n).to(io), C=r(b, t, n).to(io),
                D=0.5 + u(d), s0=None if st is None else r(b, d, n).to(st),
                reset=(u(b, t) < 0.05) if reset else None)


def mamba_work(b, t, backward=False):
    """(f32 operations, exponentials) of the selective scan over t tokens:
    per state value the decay's argument, the update and the readout (6
    operations) and one exponential; the backward adds the reverse step (15
    operations: the readout's and the state's cotangents, the dA, dt, dB,
    dC and u terms) to the recomputation, and needs each decay once more
    only if it does not keep them, so one exponential is counted."""
    per = 21 if backward else 6
    return b * t * MAMBA_D * MAMBA_N * per, b * t * MAMBA_D * MAMBA_N


def mamba_grads(torch, fn, x, dy, dsf, need_ds0):
    """(y, sf, gradients) of sum(y * dy) + sum(sf * dsf) through ``fn``
    (mamba_scan or its plain version) w.r.t. x, dt, A, B, C, D, and s0 where
    there is one and ``need_ds0``."""
    names = list(MAMBA_LEAVES[:6]) + (["s0"] if x["s0"] is not None and need_ds0 else [])
    args = {n: x[n] if n not in names else x[n].detach().clone().requires_grad_(True)
            for n in MAMBA_LEAVES}
    y, sf = fn(*(args[n] for n in MAMBA_LEAVES[:6]), initial_state=args["s0"],
               reset_mask=x["reset"])
    loss = (y.float() * dy.float()).sum() + (sf * dsf).sum()
    grads = torch.autograd.grad(loss, [args[n] for n in names])
    return y.detach(), sf.detach(), dict(zip(names, grads))


def hold_own_max(name, got, ref, rel):
    """``got`` within ``rel`` of max|ref| (no floor); both finite, non-zero."""
    import torch

    ref_max = float(ref.float().abs().max())
    require(bool(torch.isfinite(got.float()).all()) and ref_max > 0
            and float(got.float().abs().max()) > 0, f"{name}: not finite, or all zeros")
    check(name, max_err(got, ref), rel * ref_max)


def mamba_cotangents(torch, x, seed):
    """dy (b, t, d) in x's dtype and dsf (b, d, n) f32, N(0, 1) from ``seed``."""
    b, t, d = x["x"].shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dy = torch.randn(b, t, d, generator=g, device=DEVICE).to(x["x"].dtype)
    return dy, torch.randn(b, d, MAMBA_N, generator=g, device=DEVICE)


def mamba_bwd_call(mamba_cuda, x, dy, dsf, need_ds0, chunk):
    """One mamba_scan_bwd call on ``x`` with the chunk length ``chunk``
    forced; its leaves as a dict (ds0 where it comes back)."""
    args = tuple(x[k] for k in MAMBA_LEAVES[:6])
    out = mamba_cuda._bwd_launch(*args, x["s0"], x["reset"], dy, dsf, need_ds0, chunk=chunk)
    return {k: v for k, v in zip(MAMBA_LEAVES, out) if v is not None}


def mamba_bwd_chunks(mamba_cuda, b, t, d):
    """{route: chunk length} of mamba_scan_bwd at (b, t, d) (mamba_chunks)."""
    return mamba_chunks(t, mamba_cuda.mamba_scan_bwd_plan(b, t, d))


def mamba_fwd_chunks(mamba_cuda, b, t, d):
    """{route: chunk length} of mamba_scan at (b, t, d) (mamba_chunks)."""
    return mamba_chunks(t, mamba_cuda.mamba_scan_plan(b, t, d))


def mamba_chunks(t, planned):
    """{route: chunk length} at length t, every route the length has:
    "one_chunk" (the whole length) and, above one segment, "chunked" (the
    ``planned`` length where it cuts t, else two chunks)."""
    routes = {"one_chunk": -(-t // 16) * 16}
    if t > 16:
        routes["chunked"] = planned if planned < t else -(-t // 32) * 16
    return routes


def mamba_bwd_work(x, dy, dsf, got):
    """(bytes, f32 operations, exponentials) of one mamba_scan_bwd call."""
    b, t, _ = x["x"].shape
    args = tuple(x[k] for k in MAMBA_LEAVES[:6])
    return (nbytes(*args, x["s0"], x["reset"], dy, dsf, *got.values()),
            *mamba_work(b, t, backward=True))


def hold_mamba_scan(torch, mamba_cuda, shape, need_ds0=None):
    """mamba_scan at ``shape`` = (b, t, d, n, IO dtype, initial-state dtype
    or None, reset mask) against its plain version: with ``need_ds0`` None
    the inference forward (y, final state); otherwise as training calls it
    (autograd recording: the forward kernel and the hand-written backward
    on its planned chunk length) against autograd through the plain loop,
    y, the final state and the seven gradient leaves (dx, ddt, dA, dB, dC,
    dD, and ds0 where wanted), each within a share of its own max|plain|,
    finite and non-zero; then the forward called on every route
    (mamba_fwd_chunks) against the plain loop and against
    mamba_scan_chunked_plain at its chunk length, each route twice for the
    same bits; then the backward called on every route
    (mamba_bwd_chunks) against the same reference, the chunked route also
    against mamba_scan_bwd_chunked_plain at its chunk length, each route
    twice for the same bits. Returns (inputs, dy, dsf, gradients, worst
    gradient share over the routes); the last four None for the inference
    forward."""
    b, t, d, n, io, st, reset = shape
    x = mamba_inputs(torch, b, t, io, st, reset, seed=900 + t + b)
    name = (f"mamba_scan b{b} t{t} d{d} n{n} IO {dtype_name(io)} initial state "
            f"{dtype_name(st)}{', reset mask' if reset else ''}")
    args = tuple(x[k] for k in MAMBA_LEAVES[:6])
    before = mamba_cuda.launch_counts()
    result = (x, None, None, None, None)
    if need_ds0 is None:
        with torch.no_grad():
            y_k, s_k = mamba_cuda.mamba_scan(*args, initial_state=x["s0"], reset_mask=x["reset"])
            y_p, s_p = mamba_cuda.mamba_scan_plain(*args, initial_state=x["s0"],
                                                   reset_mask=x["reset"])
    else:
        dy, dsf = mamba_cotangents(torch, x, seed=t)
        y_k, s_k, got = mamba_grads(torch, mamba_cuda.mamba_scan, x, dy, dsf, need_ds0)
        y_p, s_p, ref = mamba_grads(torch, mamba_cuda.mamba_scan_plain, x, dy, dsf, need_ds0)
        name += "" if need_ds0 or st is None else ", no ds0"
    after = mamba_cuda.launch_counts()
    torch.cuda.synchronize()
    require(after["mamba_scan"] == before["mamba_scan"] + 1
            and after["mamba_scan_bwd"] == before["mamba_scan_bwd"] + (need_ds0 is not None),
            f"{name}: not launched through the kernels")
    tol_y = TOL_BF16 if io == torch.bfloat16 else TOL_F32
    print(f"{name}, forward (planned chunk length {mamba_cuda.mamba_scan_plan(b, t, d)}):")
    require(y_k.dtype == io and s_k.dtype == torch.float32, "mamba_scan output dtypes")
    hold_own_max("y", y_k, y_p, tol_y)
    hold_own_max("final state", s_k, s_p, TOL_F32)
    for route, chunk in mamba_fwd_chunks(mamba_cuda, b, t, d).items():
        call = lambda: mamba_cuda._scan_launch(*args, x["s0"], x["reset"], chunk=chunk)
        with torch.no_grad():
            first, again = call(), call()
            plain = mamba_cuda.mamba_scan_chunked_plain(*args, x["s0"], x["reset"], chunk=chunk)
        torch.cuda.synchronize()
        print(f"  forward on the {route} route (chunk length {chunk}):")
        for want, what in ((y_p, s_p), "mamba_scan_plain"), (plain, "mamba_scan_chunked_plain"):
            hold_own_max(f"y vs {what}", first[0], want[0], tol_y)
            hold_own_max(f"final state vs {what}", first[1], want[1], TOL_F32)
        require(all(torch.equal(a, k) for a, k in zip(first, again)),
                f"{name}, forward on the {route} route: a second call gave other bits")
        print(f"  a second call on the {route} route: the same bits")
        MAMBA_HELD["mamba_scan"].add((*shape, chunk))
    if need_ds0 is not None:
        tol = TOL_GRAD if io == torch.bfloat16 else TOL_F32
        planned = mamba_cuda.mamba_scan_bwd_plan(b, t, d)
        worst = check_grads(f"{name}, backward (planned chunk length {planned})", got, ref, tol)
        ds0 = bool(need_ds0 and st is not None)
        MAMBA_HELD["mamba_scan_bwd"].add((*shape, ds0, planned))
        for route, chunk in mamba_bwd_chunks(mamba_cuda, b, t, d).items():
            call = lambda: mamba_bwd_call(mamba_cuda, x, dy, dsf, need_ds0, chunk)
            first = call()
            label = f"{name}, backward on the {route} route (chunk length {chunk})"
            worst = max(worst, check_grads(label, first, ref, tol))
            if route == "chunked":
                plain = mamba_cuda.mamba_scan_bwd_chunked_plain(
                    *args, x["s0"], x["reset"], dy, dsf, need_ds0, chunk=chunk)
                check_grads(f"{label} against mamba_scan_bwd_chunked_plain", first,
                            {k: v for k, v in zip(MAMBA_LEAVES, plain) if v is not None}, tol)
            again = call()
            same = [k for k in first if not torch.equal(first[k], again[k])]
            require(not same, f"{label}: a second call gave other bits in {same}")
            print(f"  a second call on the {route} route: the same bits in all {len(first)} "
                  "leaves")
            MAMBA_HELD["mamba_scan_bwd"].add((*shape, ds0, chunk))
        result = (x, dy, dsf, got, worst)
    return result


def mamba_fwd_steps(mamba_cuda, x):
    """{route: one no-grad mamba_scan call on ``x`` on it} for time_routes."""
    b, t, d = x["x"].shape
    args = tuple(x[k] for k in MAMBA_LEAVES[:6])
    return {r: (lambda c=c: mamba_cuda._scan_launch(*args, x["s0"], x["reset"], chunk=c))
            for r, c in mamba_fwd_chunks(mamba_cuda, b, t, d).items()}


def mamba_bwd_steps(mamba_cuda, x, dy, dsf, need_ds0=False):
    """{route: one mamba_scan_bwd call on ``x`` on it} for time_routes."""
    b, t, d = x["x"].shape
    return {r: (lambda c=c: mamba_bwd_call(mamba_cuda, x, dy, dsf, need_ds0, c))
            for r, c in mamba_bwd_chunks(mamba_cuda, b, t, d).items()}


def mamba_kernel_phase(torch, mamba_cuda, summary):
    """The two Mamba kernels against their plain versions at the flagship
    mixer's width (d 2048, n 16; bf16 x, B, C; f32 dt, A, D, states): the
    forward at b8 t151 (generate's prefill) with an f32 and with no initial
    state, and at b1 for every server chunk length down to t1; forward and
    backward at b8 t512 (training) with an initial state, without one and
    with a reset mask, all seven gradient leaves, the backward on both
    routes (one chunk and chunked), each twice for equal bits. Every time
    beside its bound (bytes, f32 operations or the exponentials at the SFU
    rate) and the plain version's; the backward's two routes timed in turns
    (median of six, the planned one at most SWEEP_MARGIN slower than the
    other, retimed on a miss), each route's scratch, and a profile of three
    calls on the planned route. The summary takes the forward at b8 t151
    with an f32 state (what generate launches) and the backward's planned
    route at b8 t512 without one (what training launches)."""
    bf, f32 = torch.bfloat16, torch.float32
    d, n = MAMBA_D, MAMBA_N
    shapes = [(BATCH, T_PROMPT + 1, f32), (BATCH, T_PROMPT + 1, None)]
    shapes += [(1, t, f32) for t in CHUNK_T]
    for b, t, st in shapes:
        x = hold_mamba_scan(torch, mamba_cuda, (b, t, d, n, bf, st, False))[0]
        args = tuple(x[k] for k in MAMBA_LEAVES[:6])
        with torch.no_grad():
            ms, plain_ms = timed_pair(
                f"mamba_scan b{b} t{t} initial state {dtype_name(st)}",
                lambda: mamba_cuda.mamba_scan(*args, initial_state=x["s0"]),
                lambda: mamba_cuda.mamba_scan_plain(*args, initial_state=x["s0"]), 3)
            y_k, s_k = mamba_cuda.mamba_scan(*args, initial_state=x["s0"])
            y_p = mamba_cuda.mamba_scan_plain(*args, initial_state=x["s0"])[0]
        flops, exps = mamba_work(b, t)
        work = (nbytes(*args, x["s0"], y_k, s_k), flops, f32)
        if (b, st) == (BATCH, f32):
            record(summary, "mamba_scan", max_err(y_k, y_p), ms, plain_ms, *work, exps=exps)
        else:
            note_shape("mamba_scan", f"b{b} t{t} initial state {dtype_name(st)}", ms,
                       plain_ms, *work, exps=exps)
    t = TRAIN_T[0]
    for st, reset in ((f32, False), (None, True), (None, False)):
        x, dy, dsf, got, worst = hold_mamba_scan(
            torch, mamba_cuda, (TRAIN_BATCH, t, d, n, bf, st, reset), True)
        if st is not None or reset:
            continue
        args = tuple(x[k] for k in MAMBA_LEAVES[:6])
        with torch.no_grad():
            fwd_ms, fwd_plain_ms = timed_pair(
                f"mamba_scan training forward b{TRAIN_BATCH} t{t}",
                lambda: mamba_cuda.mamba_scan(*args), lambda: mamba_cuda.mamba_scan_plain(*args), 3)
            y_k, s_k = mamba_cuda.mamba_scan(*args)
        flops, exps = mamba_work(TRAIN_BATCH, t)
        note_shape("mamba_scan", f"training forward b{TRAIN_BATCH} t{t} initial state none",
                   fwd_ms, fwd_plain_ms, nbytes(*args, y_k, s_k), flops, f32, exps=exps)
        chunks = mamba_bwd_chunks(mamba_cuda, TRAIN_BATCH, t, d)
        planned = mamba_cuda.bwd_route(t, mamba_cuda.mamba_scan_bwd_plan(TRAIN_BATCH, t, d))
        label = f"mamba_scan_bwd b{TRAIN_BATCH} t{t}"
        ms, times = planned_route_times(mamba_bwd_steps(mamba_cuda, x, dy, dsf), planned, label)
        plain_both = lambda: mamba_grads(torch, mamba_cuda.mamba_scan_plain, x, dy, dsf, False)
        plain = [eager_ms(plain_both, 2, warmup=1) - fwd_plain_ms for _ in range(2)]
        print(f"  {label} device ms, in turns: " + ", ".join(
            f"{r} (chunk length {chunks[r]}) {times[r]}" for r in times)
            + f"; plain backward (eager forward and backward on the host's clock, less the "
            f"plain forward) {plain}")
        b_work, flops, exps = mamba_bwd_work(x, dy, dsf, got)
        # max_abs_err: the largest error of a leaf as a share of its max|plain|
        record(summary, "mamba_scan_bwd", worst, ms[planned], sum(plain) / len(plain),
               b_work, flops, f32, exps=exps)
        for r in ms:
            if r != planned:
                note_shape("mamba_scan_bwd", f"b{TRAIN_BATCH} t{t} initial state none, {r} "
                           f"route (chunk length {chunks[r]}, in turns)", ms[r], None, b_work,
                           flops, f32, exps=exps)
        print(f"  {label}: " + ", ".join(f"{r} {ms[r] * 1e3:.1f} us" for r in ms)
              + f" (median of {2 * ROUTE_TURNS} in turns); the plan takes {planned}")
        for r, c in chunks.items():
            scratch = mamba_cuda.bwd_scratch_bytes(TRAIN_BATCH, t, d, c)
            print(f"  scratch of one {r} backward call (chunk length {c}): {scratch} bytes "
                  f"({scratch / 1e6:.1f} MB)")
        profiled(torch, lambda: [mamba_bwd_steps(mamba_cuda, x, dy, dsf)[planned]()
                                 for _ in range(3)],
                 f"3 calls of mamba_scan_bwd b{TRAIN_BATCH} t{t}, {planned} route", top=8)
    reset_counts()  # the kernel phases' launches are no path's


# chunk lengths and shapes of mamba_scan_bwd's route sweep (d 2048 n16, bf16
# IO, no initial state, as training runs): they bracket mamba_scan_bwd_plan's
# threshold and reach the training lengths; then the ragged lengths the
# driven paths launch (training's t511, the gradient check's b2 t319) and
# t511 at b1 and b2, where the plan's chunk length is not a power of two
MAMBA_BWD_CHUNKS = (16, 32, 64, 128, 256)
MAMBA_BWD_SWEEP_B = (1, 2, 4, 8)
MAMBA_BWD_SWEEP_T = (16, 32, 48, 64, 96, 128, 256, 512)
MAMBA_BWD_SWEEP_RAGGED = ((1, 511), (2, 319), (2, 511), (4, 511), (8, 511))


def mamba_bwd_route_sweep(torch, mamba_cuda, card_line):
    """mamba_scan_bwd timed in turns at every chunk length of
    MAMBA_BWD_CHUNKS below t and at one chunk, over MAMBA_BWD_SWEEP_B x
    MAMBA_BWD_SWEEP_T and MAMBA_BWD_SWEEP_RAGGED (there also a segment
    either side of the planned length), beside the length
    mamba_scan_bwd_plan picks:
    where the plan comes from. Every point is timed and printed first
    (median of six turns); then at every point the planned length may be at
    most SWEEP_MARGIN slower than the fastest, a point that misses timed
    again (planned_route_times) before the sweep fails on it."""
    bf = torch.bfloat16
    print(f"mamba_scan_bwd chunk-length sweep (d{MAMBA_D} n{MAMBA_N}, bf16 IO, no initial "
          f"state; device us, median of {2 * ROUTE_TURNS} in turns; L{{t}} is one chunk) "
          f"[{card_line}]:")
    misses = []
    points = [(b, t) for b in MAMBA_BWD_SWEEP_B for t in MAMBA_BWD_SWEEP_T]
    for b, t in points + list(MAMBA_BWD_SWEEP_RAGGED):
        x = mamba_inputs(torch, b, t, bf, None, False, seed=960 + t + b)
        dy, dsf = mamba_cotangents(torch, x, seed=961 + t)
        plan = mamba_cuda.mamba_scan_bwd_plan(b, t, MAMBA_D)
        lengths = {c for c in MAMBA_BWD_CHUNKS if c < t} | {-(-t // 16) * 16, plan}
        if (b, t) in MAMBA_BWD_SWEEP_RAGGED:
            lengths |= set(mamba_bwd_neighbours(t, plan))
        steps = {f"L{c}": (lambda c=c, x=x, dy=dy, dsf=dsf: mamba_bwd_call(
            mamba_cuda, x, dy, dsf, False, c)) for c in sorted(lengths)}
        ms, _ = time_routes(steps)
        best = min(ms, key=ms.get)
        print(f"  b{b} t{t}: " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in ms.items())
              + f"; planned L{plan}, fastest {best}")
        if ms[f"L{plan}"] > ms[best] * (1 + SWEEP_MARGIN):
            misses.append((b, t, plan, steps))
    for b, t, plan, steps in misses:  # fails here unless a second round clears it
        planned_route_times(steps, f"L{plan}", f"mamba_scan_bwd sweep b{b} t{t}")
    reset_counts()  # the sweep's launches are no path's


# shapes of mamba_scan's chunk-length sweep (d 2048 n16, bf16 IO, no initial
# state): MAMBA_BWD_SWEEP_B x MAMBA_BWD_SWEEP_T bracket mamba_scan_plan's
# thresholds; then the ragged lengths the driven paths launch (generate's
# prefill t151, training's t511, the gradient check's b2 t319) and b1 t151
MAMBA_FWD_SWEEP_RAGGED = ((1, 151), (8, 151), (2, 319), (4, 511), (8, 511))


def mamba_fwd_route_sweep(torch, mamba_cuda, card_line):
    """mamba_scan timed in turns at every chunk length of MAMBA_BWD_CHUNKS
    below t and at one chunk, over MAMBA_BWD_SWEEP_B x MAMBA_BWD_SWEEP_T and
    MAMBA_FWD_SWEEP_RAGGED (there also a segment either side of the planned
    length), beside the length mamba_scan_plan picks: where the plan comes
    from. Every point is timed and printed first (median of six turns); then
    at every point the planned length may be at most SWEEP_MARGIN slower
    than the fastest, a point that misses timed again (planned_route_times)
    before the sweep fails on it. The launch counts are reset afterwards:
    the forced lengths are no path's."""
    bf = torch.bfloat16
    print(f"mamba_scan chunk-length sweep (d{MAMBA_D} n{MAMBA_N}, bf16 IO, no initial state; "
          f"device us, median of {2 * ROUTE_TURNS} in turns; L{{t}} is one chunk) [{card_line}]:")
    misses = []
    points = [(b, t) for b in MAMBA_BWD_SWEEP_B for t in MAMBA_BWD_SWEEP_T]
    with torch.no_grad():
        for b, t in points + list(MAMBA_FWD_SWEEP_RAGGED):
            x = mamba_inputs(torch, b, t, bf, None, False, seed=990 + t + b)
            args = tuple(x[k] for k in MAMBA_LEAVES[:6])
            plan = mamba_cuda.mamba_scan_plan(b, t, MAMBA_D)
            lengths = {c for c in MAMBA_BWD_CHUNKS if c < t} | {-(-t // 16) * 16, plan}
            if (b, t) in MAMBA_FWD_SWEEP_RAGGED:
                lengths |= set(mamba_bwd_neighbours(t, plan))
            steps = {f"L{c}": (lambda c=c, args=args: mamba_cuda._scan_launch(*args, chunk=c))
                     for c in sorted(lengths)}
            ms, _ = time_routes(steps)
            best = min(ms, key=ms.get)
            print(f"  b{b} t{t}: " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in ms.items())
                  + f"; planned L{plan}, fastest {best}")
            if ms[f"L{plan}"] > ms[best] * (1 + SWEEP_MARGIN):
                misses.append((b, t, plan, steps))
        for b, t, plan, steps in misses:  # fails here unless a second round clears it
            planned_route_times(steps, f"L{plan}", f"mamba_scan sweep b{b} t{t}")
    reset_counts()  # the sweep's launches are no path's


def mamba_bwd_neighbours(t, chunk):
    """The chunk lengths a segment either side of ``chunk`` that still cut
    t into more than one chunk."""
    return [c for c in (chunk - 16, chunk + 16) if 16 <= c < t]


def mamba_gap_phase(torch, mamba_cuda, card_line):
    """launches x (time - bound) of mamba_scan and of mamba_scan_bwd over the
    Mamba main paths: every shape they launched each on, weighted by its
    launch count (GAP_SHAPE_COUNTS), held against the plain version on every
    route (launched_mamba_shapes_phase), timed here beside the shape's
    bound on its routes in turns and, where it took the chunked route, at a
    segment either side of its chunk length too (median of six, retimed on
    a miss; the length taken at most SWEEP_MARGIN slower than the fastest).
    Prints each shape, the sums and the sums had every launch taken one
    chunk; returns {kernel: sum on the routes taken}."""
    f32 = torch.float32
    sums = {}
    counts = GAP_SHAPE_COUNTS["mamba_scan"]
    require(counts, "mamba_scan: the main paths launched it on no shape")
    total = {"taken": 0.0, "one_chunk": 0.0}
    print(f"mamba_scan: launches x (time - bound) over {sum(counts.values())} main-path "
          f"launches on {len(counts)} shapes (device us; the route taken, the one-chunk walk, "
          f"the bound):")
    for shape, n in sorted(counts.items(), key=str):
        b, t, d, _, io, st, reset, chunk = shape
        route = mamba_cuda.bwd_route(t, chunk)
        require(mamba_fwd_chunks(mamba_cuda, b, t, d)[route] == chunk,
                f"mamba_scan: {shape} took chunk length {chunk}, not its plan's")
        x = mamba_inputs(torch, b, t, io, st, reset, seed=780 + t + b)
        args = tuple(x[k] for k in MAMBA_LEAVES[:6])
        steps = mamba_fwd_steps(mamba_cuda, x)
        if route == "chunked":
            steps.update({f"L{c}": (lambda c=c: mamba_cuda._scan_launch(
                *args, x["s0"], x["reset"], chunk=c)) for c in mamba_bwd_neighbours(t, chunk)})
        with torch.no_grad():
            y, sf = steps[route]()
            label = f"mamba_scan b{b} t{t} IO {dtype_name(io)} {dtype_name(st)}"
            ms = (planned_route_times(steps, route, label)[0] if len(steps) > 1
                  else time_routes(steps)[0])
        flops, exps = mamba_work(b, t)
        bound_ms = roofline(nbytes(*args, x["s0"], x["reset"], y, sf), flops, f32, exps)[0]
        total["taken"] += n * (ms[route] - bound_ms)
        total["one_chunk"] += n * (ms["one_chunk"] - bound_ms)
        others = "".join(f", {k} {v * 1e3:.2f}" for k, v in ms.items() if k.startswith("L"))
        print(f"  {shape}: {n} launches; {route} {ms[route] * 1e3:.2f}, one chunk "
              f"{ms['one_chunk'] * 1e3:.2f}{others}, bound {bound_ms * 1e3:.3f}")
        for r, c in mamba_fwd_chunks(mamba_cuda, b, t, d).items():
            note_shape("mamba_scan", f"b{b} t{t} IO {dtype_name(io)} initial state "
                       f"{dtype_name(st)}{', reset mask' if reset else ''}, {r} route (chunk "
                       f"length {c}){' (planned)' if r == route else ''}, {n} main-path "
                       "launches, in turns", ms[r], None,
                       nbytes(*args, x["s0"], x["reset"], y, sf), flops, f32, exps=exps)
    print(f"  mamba_scan: sum of launches x (time - bound) {total['taken']:.3f} ms on the routes "
          f"taken; {total['one_chunk']:.3f} ms had every launch taken the one-chunk walk "
          f"[{card_line}]")
    sums["mamba_scan"] = total["taken"]
    counts = GAP_SHAPE_COUNTS["mamba_scan_bwd"]
    require(counts, "mamba_scan_bwd: the main paths launched it on no shape")
    total = {"taken": 0.0, "one_chunk": 0.0}
    print(f"mamba_scan_bwd: launches x (time - bound) over {sum(counts.values())} main-path "
          f"launches on {len(counts)} shapes (device us; the route taken, the one-chunk body, "
          f"the bound):")
    for shape, n in sorted(counts.items(), key=str):
        b, t, d, _, io, st, reset, need_ds0, chunk = shape
        route = mamba_cuda.bwd_route(t, chunk)
        x = mamba_inputs(torch, b, t, io, st, reset, seed=780 + t + b)
        dy, dsf = mamba_cotangents(torch, x, seed=781 + t)
        work, flops, exps = mamba_bwd_work(x, dy, dsf,
                                           mamba_bwd_call(mamba_cuda, x, dy, dsf, need_ds0, chunk))
        bound_ms = roofline(work, flops, f32, exps)[0]
        steps = mamba_bwd_steps(mamba_cuda, x, dy, dsf, need_ds0)
        require(mamba_bwd_chunks(mamba_cuda, b, t, d)[route] == chunk,
                f"mamba_scan_bwd: {shape} took chunk length {chunk}, not its plan's")
        if route == "chunked":
            steps.update({f"L{c}": (lambda c=c: mamba_bwd_call(mamba_cuda, x, dy, dsf,
                                                              need_ds0, c))
                          for c in mamba_bwd_neighbours(t, chunk)})
        label = f"mamba_scan_bwd b{b} t{t} IO {dtype_name(io)} {dtype_name(st)}"
        ms = planned_route_times(steps, route, label)[0] if len(steps) > 1 else time_routes(steps)[0]
        total["taken"] += n * (ms[route] - bound_ms)
        total["one_chunk"] += n * (ms["one_chunk"] - bound_ms)
        others = "".join(f", {k} {v * 1e3:.2f}" for k, v in ms.items() if k.startswith("L"))
        print(f"  {shape}: {n} launches; {route} {ms[route] * 1e3:.2f}, one chunk "
              f"{ms['one_chunk'] * 1e3:.2f}{others}, bound {bound_ms * 1e3:.3f}")
    print(f"  mamba_scan_bwd: sum of launches x (time - bound) {total['taken']:.3f} ms on the "
          f"routes taken; {total['one_chunk']:.3f} ms had every launch taken the one-chunk body "
          f"[{card_line}]")
    sums["mamba_scan_bwd"] = total["taken"]
    return sums


def mamba_phase(torch, np, gla_cuda, card_line):
    """Mamba (v1) at the flagship's width (lina_gla_169m with kind="mamba",
    314,976,578 parameters, random weights from seed 0 with A_log, D and
    dt_proj's bias drawn off their inits, bf16 compute, f32 states):
    generate_batch for 8 requests (classic loop; mamba_scan for the
    prefill, the plain selective_step for each token) with the kernel path
    held against the plain path under teacher forcing (in bf16, and on a
    copy built in f32 compute), a DecodeServer in classic mode (8 requests,
    8 slots) and three train steps at b8 (mamba_scan and its backward), the
    kernel path's loss and parameter gradients held against the plain
    path's on a batch of 2; then the interleaved CrossAttMamba (cross
    attention after layers 5 and 11): a 16-token generate and one train
    step. Mamba has no lazy window and no S0 tuning, as in JAX."""
    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.mamba import MambaMixer, perturb_mamba_params_
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    cfg = variant_cfg("mamba")
    prepare = lambda m: perturb_mamba_params_(m, torch.Generator().manual_seed(0))
    model = build_model(cfg, device=DEVICE, seed=0)
    prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    mixers = [m for m in model.modules() if isinstance(m, MambaMixer)]
    widths = {(m.d_inner, m.d_state, m.d_conv, m.dt_rank) for m in mixers}
    state = model.empty_state(1, DEVICE).layers[0]
    print(f"Mamba: {n_params:,} parameters, {len(mixers)} mixers (d_inner, d_state, d_conv, "
          f"dt_rank) {widths}, state h {state.h.dtype}")
    require(n_params == N_MAMBA_PARAMS, f"{n_params} parameters, expected {N_MAMBA_PARAMS}")
    require(len(mixers) == N_GLA_LAYERS and widths == {(MAMBA_D, MAMBA_N, 4, 64)},
            f"Mamba mixers {widths}")
    require(state.h.dtype == torch.float32, "Mamba states not f32")
    names = dict(chunk="mamba_scan", decode=None)
    f32_copy = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device=DEVICE,
                           seed=0)
    prepare(f32_copy)
    total = variant_generate_phase(torch, np, gla_cuda, model, cfg, card_line, lazy=False,
                                   f32_copy=f32_copy, **names)
    del f32_copy
    add_launches(total, variant_serving_phase(torch, np, gla_cuda, model, cfg, card_line, **names))
    del model
    torch.cuda.empty_cache()
    model, _, train, check_model = training_phase(
        torch, np, gla_cuda, card_line, cfg, "mamba_scan", "mamba_scan_bwd",
        VARIANT_TRAIN_STEPS["mamba"], prepare=prepare)
    add_launches(total, train)
    del model, check_model
    torch.cuda.empty_cache()

    cfg = variant_cfg("mamba", cross_att_layers=INTERLEAVED_LAYERS, blind=False)
    model = build_model(cfg, device=DEVICE, seed=0)
    prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = cfg.backbone.n_layer
    require(n_params == N_CROSSATT_MAMBA_PARAMS,
            f"CrossAttMamba: {n_params} parameters, expected {N_CROSSATT_MAMBA_PARAMS}")
    text = torch.from_numpy(np.random.default_rng(4).integers(
        3, cfg.n_txt_vocab, size=(SHORT_BATCH, TEXT_LEN))).to(DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, max_seqlen=1 + SHORT_STEPS, k=1, force_max_seqlen=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"CrossAttMamba: {n_params:,} parameters, generate_batch b{SHORT_BATCH} "
          f"{SHORT_STEPS} tokens, {wall:.3f} s wall [{card_line}]; launches {launches}")
    expect_launches(launches, mamba_scan=n_layers)
    require(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < model.n_target_vocab,
            "CrossAttMamba: tokens out of range")
    add_launches(total, launches)
    state = create_train_state(model, TrainConfig(n_warmup_steps=2, n_training_steps=100))
    batch = batch_to_device(next(synthetic_tts_batches(
        batch_size=TRAIN_BATCH, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
        min_audio_len=MIN_AUDIO, max_audio_len=MAX_AUDIO, seed=2)), DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, metrics = make_train_step(model)(state, batch, torch.Generator(device=DEVICE))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"CrossAttMamba train step b{TRAIN_BATCH} (t {batch['y_mask'].shape[1]}): loss "
          f"{loss:.4f}, grad_norm {norm:.4f}, {ms:.1f} ms [{card_line}]; launches {launches}")
    require(np.isfinite(loss) and np.isfinite(norm) and norm > 0,
            f"CrossAttMamba step: loss {loss}, grad_norm {norm}")
    expect_launches(launches, mamba_scan=n_layers, mamba_scan_bwd=n_layers)
    add_launches(total, launches)
    del model, state
    torch.cuda.empty_cache()
    return total


def launched_mamba_shapes_phase(torch, mamba_cuda):
    """Every shape the driven Mamba paths launched the two Mamba kernels on
    is held against the plain version now, the backward on every route,
    unless the Mamba kernel phase held it already."""
    todo = {n: sorted(MAMBA_LAUNCHED[n] - MAMBA_HELD[n], key=str) for n in MAMBA_LAUNCHED}
    print("the driven Mamba paths launched " + ", ".join(
        f"{n} on {len(MAMBA_LAUNCHED[n])} shapes ({len(todo[n])} not held yet)" for n in todo))
    require(all(MAMBA_LAUNCHED.values()), f"a Mamba kernel launched on no shape: {MAMBA_LAUNCHED}")
    for shape in todo["mamba_scan_bwd"]:  # (..., need_ds0, chunk length): held on every route
        hold_mamba_scan(torch, mamba_cuda, shape[:7], need_ds0=shape[7])
    for shape in sorted(MAMBA_LAUNCHED["mamba_scan"] - MAMBA_HELD["mamba_scan"], key=str):
        hold_mamba_scan(torch, mamba_cuda, shape[:7])  # (..., chunk length): on every route
    require(all(MAMBA_LAUNCHED[n] <= MAMBA_HELD[n] for n in MAMBA_LAUNCHED),
            "Mamba: launched but not held")


# ------------------------------------------------------------------ folds
def fold_case(torch, shape, seed):
    """A full window's fold inputs at ``shape`` = (b, h, dk, dv, IO dtype,
    state dtype, L) as a main path leaves them: cumsums of log-gates in
    cbuf, cc the last, k and v of a few units; an int8 state with its row
    scales. Returns (state, s_scale or None, bufs)."""
    from lina_speech_tpu_torch.ops.gla import quantize_state_rows

    b, h, dk, dv, io, st, L = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=DEVICE)
    cums = (torch.nn.functional.logsigmoid(r(L, b, h, dk)) / 16).cumsum(0)
    bufs = [(r(L, b, h, dk) * 9).to(io), (r(L, b, h, dv) * 3).to(io), cums.contiguous(),
            cums[-1].clone()]
    if st == torch.int8:
        return (*quantize_state_rows(r(b, h, dk, dv) * 0.05), bufs)
    return r(b, h, dk, dv).to(st), None, bufs


def fold_work(state, s_scale, bufs):
    """(bytes, operations) of one fold: the state (and an int8 state's
    scales) read and written once, the window read once; per state element
    2 L for the update, the decay, and four more to dequantize and
    requantize an int8 one."""
    b, h, dk, dv = state.shape
    L = bufs[0].shape[0]
    per = 2 * L + (4 if s_scale is not None else 1)
    return (nbytes(state, state, s_scale, s_scale, *bufs), b * h * dk * (dv * per + 2 * L))


def fold_on_route(gla_cuda, route, state, s_scale, bufs):
    """One fold in the bands of ``route`` (the wrappers' launchers, forced)."""
    if s_scale is None:
        return gla_cuda._fold_launch(state, *bufs, route=route)
    return gla_cuda._fold_q_launch(state, s_scale, *bufs, route=route)


def hold_fold_routes(torch, gla_cuda, shape, seed):
    """One fold at ``shape`` (fold_case's) on every band height the head
    takes, held against the plain version and the plain mirror of its
    bf16-part decomposition: a float state within a share of max(1,
    max|plain|) (TOL_F32 for f32 IO and state, else TOL_BF16), an int8 one
    at most one integer step off on at most 1e-3 of the elements, its
    scales to 1e-5 of each; updated in place, equal bits on a second call.
    Returns ({route: a step on cold states}, (bytes, operations))."""
    b, h, dk, dv, io, st, L = shape
    state, s_scale, bufs = fold_case(torch, shape, seed)
    quant = s_scale is not None
    if quant:
        refs = [gla_cuda.gla_fold_q_plain(state, s_scale, *bufs),
                gla_cuda.gla_fold_q_parts_plain(state, s_scale, *bufs)]
    else:
        refs = [gla_cuda.gla_fold_plain(state, *bufs), gla_cuda.gla_fold_parts_plain(state, *bufs)]
    tol = TOL_F32 if io == st == torch.float32 else TOL_BF16
    rotation = cold_rotation(state) if not quant else cold_rotation(state, s_scale)
    steps = {}
    for r in gla_cuda.fold_band_heights(dk, dv, st):
        route = f"band{r}"
        args = (state.clone(), s_scale.clone() if quant else None)
        out = fold_on_route(gla_cuda, route, *args, bufs)
        again = fold_on_route(gla_cuda, route, state.clone(),
                              s_scale.clone() if quant else None, bufs)
        torch.cuda.synchronize()
        if quant:
            require(out[0] is args[0] and out[1] is args[1], f"{shape} {route}: not in place")
            require(torch.equal(out[0], again[0]) and torch.equal(out[1], again[1]),
                    f"{shape} {route}: a second call gave other bits")
            for name, (rq, rsc) in zip(("plain", "parts mirror"), refs):
                d = (out[0].int() - rq.int()).abs()
                top, off = int(d.max()), int((d > 0).sum())
                require(top <= 1 and off <= 1e-3 * d.numel(),
                        f"{shape} {route}: int8 state {top} steps from the {name}, {off} differ")
                rel = float(((out[1] - rsc).abs() / rsc).max())
                require(rel <= 1e-5, f"{shape} {route}: scales {rel} from the {name}")
        else:
            require(out is args[0], f"{shape} {route}: not in place")
            require(torch.equal(out, again), f"{shape} {route}: a second call gave other bits")
            require(bool(torch.isfinite(out.float()).all()), f"{shape} {route}: not finite")
            check(f"{route} vs plain", max_err(out, refs[0]), bound(refs[0], tol))
            check(f"{route} vs parts mirror", max_err(out, refs[1]), bound(refs[1], tol))

        def step(route=route):
            s, *sc = rotation()
            return fold_on_route(gla_cuda, route, s, sc[0] if sc else None, bufs)

        steps[route] = step
    return steps, fold_work(state, s_scale, bufs)


# (h, dk, dv, IO dtype name, state dtype name, batches) of fold_route_sweep:
# the flagship's head on its three state types, simple-GLA's and Mamba-2's
FOLD_SWEEP = [((H, DK, DV, "bfloat16", st), (1, 8, 64)) for st in ("bfloat16", "float32", "int8")]
FOLD_SWEEP += [((*SIMPLE_HEAD, "bfloat16", "float32"), (8,)),
               ((*MAMBA_HEAD, "float32", "float32"), (8,))]


def fold_route_sweep(torch, gla_cuda, card_line):
    """Every band height of the two folds timed in turns on cold states at
    the heads and batches of FOLD_SWEEP, a window of WINDOW slots, beside
    the band the plan picks: where gla_fold_plan's rule comes from. Prints
    only; the launched shapes are held to the plan in fold_gap_phase."""
    print(f"fold route sweep (window {WINDOW}; device us, median of {2 * ROUTE_TURNS} in turns) "
          f"[{card_line}]:")
    for i, ((h, dk, dv, io, st), batches) in enumerate(FOLD_SWEEP):
        io, st = getattr(torch, io), getattr(torch, st)
        for b in batches:
            state, s_scale, bufs = fold_case(torch, (b, h, dk, dv, io, st, WINDOW), seed=1200 + i)
            rotation = cold_rotation(state) if s_scale is None else cold_rotation(state, s_scale)

            def step(route):
                s, *sc = rotation()
                return fold_on_route(gla_cuda, route, s, sc[0] if sc else None, bufs)

            steps = {f"band{r}": (lambda r=r: step(f"band{r}"))
                     for r in gla_cuda.fold_band_heights(dk, dv, st)}
            ms, _ = time_routes(steps)
            plan = (gla_cuda.gla_fold_q_plan(b, h, dk, dv) if st == torch.int8
                    else gla_cuda.gla_fold_plan(b, h, dk, dv, st))
            best = min(ms, key=ms.get)
            bound_ms = roofline(*fold_work(state, s_scale, bufs), io)[0]
            print(f"  b{b} {head_name(h, dk, dv)} IO {dtype_name(io)} state {dtype_name(st)}: "
                  + ", ".join(f"{r} {v * 1e3:.3f}" for r, v in ms.items())
                  + f"; bound {bound_ms * 1e3:.3f}; planned {plan}, fastest {best}"
                  + ("" if plan == best else f" ({ms[plan] / ms[best] - 1:+.1%})"))


def fold_gap_phase(torch, gla_cuda, card_line):
    """Every shape a main path launched the two folds on (GAP_SHAPE_COUNTS)
    held on every band height (hold_fold_routes) and the heights timed in
    turns on cold states beside the bound: the planned one at most
    SWEEP_MARGIN slower than the fastest other (planned_route_times).
    launches x (time - bound) summed over them on the planned bands. The
    first design of each fold (the DK x 32 column tile, the 32-row int8
    body) lost at every launched shape and is gone: scripts/torch_lazy_ab.py
    times it against this one from a checkout of its commit. Returns
    {kernel: sum in ms}."""
    sums = {}
    for name in ("gla_fold", "gla_fold_q"):
        counts = GAP_SHAPE_COUNTS[name]
        require(counts, f"{name}: the main paths launched it on no shape")
        total = 0.0
        print(f"{name}: launches x (time - bound) over {sum(counts.values())} main-path launches "
              f"on {len(counts)} shapes (device us; every band height in turns):")
        for i, (shape, n) in enumerate(sorted(counts.items(), key=str)):
            b, h, dk, dv, io, st, L = shape
            plan = (gla_cuda.gla_fold_q_plan(b, h, dk, dv) if st == torch.int8
                    else gla_cuda.gla_fold_plan(b, h, dk, dv, st))
            steps, work = hold_fold_routes(torch, gla_cuda, shape, seed=1100 + i)
            if len(steps) > 1:
                ms, times = planned_route_times(steps, plan, f"{name} {shape}")
            else:
                ms, times = time_routes(steps)
            bound_ms = roofline(*work, io)[0]
            total += n * (ms[plan] - bound_ms)
            tag = (f"b{b} {head_name(h, dk, dv)} IO {dtype_name(io)} state {dtype_name(st)} "
                   f"L{L}")
            for r in ms:
                note_shape(name, f"{tag}, {r}{' (planned)' if r == plan else ''}, {n} main-path "
                           "launches, in turns", ms[r], None, *work, io)
            print(f"  {tag}: {n} launches; " + ", ".join(
                f"{r}{' (planned)' if r == plan else ''} {ms[r] * 1e3:.3f}" for r in ms)
                + f", bound {bound_ms * 1e3:.3f} (medians; turns, ms: {times})")
        print(f"  {name}: sum of launches x (time - bound) {total:.3f} ms on the planned bands "
              f"[{card_line}]")
        sums[name] = total
    return sums


def sfu_rate(torch) -> float:
    """Exponentials per second of the card's special-function units at its
    highest SM clock (nvidia-smi clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = SFU_PER_CLOCK * sms * float(mhz) * 1e6
    print(f"SFU rate: {SFU_PER_CLOCK} a clock x {sms} SMs x {mhz} MHz = {rate:.4e} exp/s")
    return rate


CFG_COEF, CFG_BATCH, CFG_STEPS, CFG_SLOTS = 3.0, 4, 64, 4
# the f32 copy's checks: generate_batch for 32 steps, the guided logits
# against the CPU on the first two requests
CFG_F32_STEPS, CFG_CPU_ROWS = 32, 2
TRANSFORMER_STEPS, TRANSFORMER_Q_STEPS, N_TRANSFORMER_BLOCKS = 64, 32, 12
TRANSFORMER_TRAIN_T, TRANSFORMER_TIMED_T = 128, 512
# the softmax transformer's decode: one int8 product for the qkv of each
# block and three for the cross-attention's q, k and v; one fused FFN a block
TRANSFORMER_INT8_LINEARS = N_TRANSFORMER_BLOCKS + 3


def spk_encoder_params(d, dim_inner, n_layers) -> int:
    """Parameters of SimpleSpeakerEncoder: in_proj and out_proj, and per
    layer the qkv Linear, two LayerNorms and the SwiGLU (hidden 4/3 of
    dim_inner), every Linear with its bias."""
    hidden = dim_inner * 4 // 3
    layer = (3 * dim_inner * dim_inner + 3 * dim_inner + 4 * dim_inner
             + 2 * hidden * dim_inner + 2 * hidden + hidden * dim_inner + dim_inner)
    return n_layers * layer + 2 * d * dim_inner + dim_inner + d


def guided_teacher_forced(torch, model, text, prompt, tokens, n_steps):
    """Classifier-free guided logits under teacher forcing, as
    generate_batch computes them: the text and its all-mask rows encoded
    together, the speaker vector on the prompt's first embedding, the
    doubled prefill and ``n_steps`` steps that follow ``tokens``; each
    prediction l_u + CFG_COEF (l_c - l_u). Returns (b, 1 + n_steps, q, l) in
    f32 on the host."""
    b, n_pre = text.shape[0], prompt.shape[-1] + 1
    tile = lambda z: torch.cat([z, z], dim=0)
    guide = lambda lg: (lg[b:] + CFG_COEF * (lg[:b] - lg[b:])).float().cpu()
    dev = text.device
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
        x_enc = model.encode_text(tile(text).masked_fill(
            torch.arange(2 * b, device=dev)[:, None] >= b, model.n_txt_vocab - 1))
        start = model.embed_tokens(torch.ones(1, b, 1, dtype=torch.long, device=dev))
        p_in = model.embed_tokens(prompt + model.n_special_token_in)
        p_in = torch.cat([model.spk_encoder(p_in)[:, None].to(p_in.dtype), p_in[:, 1:]], 1)
        logits_pre, _, st = model.prefill(tile(torch.cat([start, p_in], 1)), x_enc,
                                          model.empty_state(2 * b, dev))
        out = [guide(logits_pre[:, -1])]
        follow = tile(model.embed_tokens(tokens[:, :, n_pre:n_pre + n_steps]))
        for i in range(n_steps):
            lg, _, st = model.decode_step(follow[:, i], x_enc, st, time_step=n_pre + i)
            out.append(guide(lg))
    return torch.stack(out, 1)


def hold_f32_conv_chunks(torch, gla_cuda, shapes):
    """gla_chunk_conv with f32 IO (a model built in f32 compute) against its
    plain version at each (b, t, initial-state dtype) of ``shapes``: o and
    the final state within TOL_F32 of max(1, max|plain|)."""
    for b, t, st in sorted(shapes, key=str):
        x = kernel_inputs(torch, b, t, st, seed=900 + b + t)
        args = [x[n].float() for n in ("xq", "xk", "xv")] + [x["gk"]] + [
            x[n].float() for n in ("wq", "wk", "wv")]
        o_k, s_k = gla_cuda.gla_chunk_conv(*args, initial_state=x["s0"])
        o_p, s_p = gla_cuda.gla_chunk_conv_plain(*args, initial_state=x["s0"])
        torch.cuda.synchronize()
        print(f"gla_chunk_conv b{b} t{t} f32 IO, initial state {st}, kernel vs plain:")
        check("o", max_err(o_k, o_p), bound(o_p, TOL_F32))
        check("final state", max_err(s_k, s_p), bound(s_p, TOL_F32))


def cfg_spk_phase(torch, np, gla_cuda, card_line):
    """Classifier-free guidance and the speaker encoder on the flagship
    (phase 15 of the module docstring). Returns the launch counts of its
    main-path runs."""
    import copy

    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
    from lina_speech_tpu_torch.config import SpeakerEncoderConfig, build_model, lina_gla_169m
    from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
    from lina_speech_tpu_torch.generate import cut_outputs, generate_batch
    from lina_speech_tpu_torch.pipeline import TTSPipeline
    from lina_speech_tpu_torch.serving import DecodeServer, _pow2_chunks

    started = time.perf_counter()
    last = [started]

    def step_took(step):
        now = time.perf_counter()
        print(f"  ({step}) took {now - last[0]:.1f} s")
        last[0] = now

    cfg = lina_gla_169m(compute_dtype="bfloat16", mask_text_p=0.1,
                        spk_encoder=SpeakerEncoderConfig())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                state_dtype="bfloat16"))
    model = build_model(cfg, device=DEVICE, seed=0)
    se = cfg.spk_encoder
    n_spk = sum(p.numel() for p in model.spk_encoder.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"CFG phase: lina_gla_169m with mask_text_p=0.1 and SpeakerEncoderConfig() "
          f"(dim_inner {se.dim_inner}, {se.heads} heads, {se.n_layers} layers, window "
          f"{se.window_length}): {n_params:,} parameters, {n_spk:,} of them the speaker encoder")
    require(n_spk == spk_encoder_params(D_MODEL, se.dim_inner, se.n_layers)
            and n_params == N_PARAMS + D_MODEL + n_spk,
            f"{n_params} parameters ({n_spk} speaker encoder)")
    rng = np.random.default_rng(15)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab - 1,
                                         size=(CFG_BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook,
                                           size=(1, CFG_BATCH, T_PROMPT))).to(DEVICE)
    n_pre = T_PROMPT + 1
    max_seqlen = n_pre + CFG_STEPS
    reset_counts()  # the earlier phases' kernel holds are no path's
    total = dict.fromkeys(read_counts(), 0)

    # (a) the main path: guided, greedy, b4 -> the kernels at b8
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, prompt=prompt, max_seqlen=max_seqlen, k=1,
                         force_max_seqlen=True, cfg_coef=CFG_COEF)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    decode_rows = {shape[0] for shape in gla_cuda.launch_shapes()["gla_decode_conv"]}
    print(f"(a) generate_batch(cfg_coef={CFG_COEF}): {CFG_BATCH} requests ({2 * CFG_BATCH} rows), "
          f"{res.n_steps} steps ({CFG_STEPS} decoded), {wall:.3f} s wall, "
          f"{wall * 1e3 / CFG_STEPS:.2f} ms a decoded step with the prefill [{card_line}]")
    print(f"  launches: {launches}; gla_decode_conv rows {sorted(decode_rows)}")
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_conv=N_GLA_LAYERS * CFG_STEPS)
    require(decode_rows == {2 * CFG_BATCH}, f"the guided steps ran at {decode_rows} rows")
    require(res.tokens.shape == (cfg.n_quant, CFG_BATCH, max_seqlen)
            and int(res.tokens.min()) >= 0 and int(res.tokens.max()) < model.n_target_vocab,
            "guided tokens out of range")
    add_launches(total, launches)
    # the decode token alone, guided at b4 (8 rows) and unguided at b8, host clock
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
        x_enc = model.encode_text(torch.cat([text, text]))
        follow = model.embed_tokens(res.tokens[:, :, n_pre:n_pre + TF_STEPS])
        follow = torch.cat([follow, follow])
        st0 = model.prefill(follow[:, :8], x_enc, model.empty_state(2 * CFG_BATCH, DEVICE))[2]
        torch.cuda.synchronize()
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            st = st0
            for i in range(TF_STEPS):
                st = model.decode_step(follow[:, i], x_enc, st)[2]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / TF_STEPS)
    print(f"  decode_step at {2 * CFG_BATCH} rows (a guided b{CFG_BATCH} token; an unguided b8 "
          f"token is the same work): {ms} ms a token, host clock [{card_line}]")
    reset_counts()
    step_took("a")

    # (b) on a copy built in f32 compute: cfg_coef=1 is the unguided run
    f32cfg = dataclasses.replace(cfg, compute_dtype="float32", backbone=dataclasses.replace(
        cfg.backbone, state_dtype="float32"))
    f32 = build_model(f32cfg, device=DEVICE, seed=0)
    greedy = dict(prompt=prompt, max_seqlen=n_pre + CFG_F32_STEPS, k=1, force_max_seqlen=True)
    runs = {}
    for coef in (None, 1.0, CFG_COEF):
        reset_counts()
        runs[coef] = generate_batch(f32, text, cfg_coef=coef, **greedy)
        launches = read_counts()
        require(launches == {**dict.fromkeys(launches, 0), "gla_chunk_conv": N_GLA_LAYERS,
                             "gla_decode_conv": N_GLA_LAYERS * CFG_F32_STEPS},
                f"f32 copy, cfg_coef={coef}: launches {launches}")
        add_launches(total, launches)
    same = torch.equal(runs[None].tokens, runs[1.0].tokens)
    moved = float((runs[CFG_COEF].tokens != runs[None].tokens).float().mean())
    print(f"(b) f32 copy, greedy b{CFG_BATCH}, {CFG_F32_STEPS} steps: cfg_coef=1.0 tokens equal "
          f"to the unguided run's: "
          f"{same}; cfg_coef={CFG_COEF} changes {moved:.3f} of the tokens")
    require(same, "cfg_coef=1.0 differs from the unguided run")
    tile = lambda z: torch.cat([z, z], dim=1)
    text2 = torch.cat([text, torch.full_like(text, f32.n_txt_vocab - 1)])
    teacher_forced_check(torch, f32, f32cfg, text2, tile(prompt), tile(runs[CFG_COEF].tokens),
                         card_line, (TOL_F32,) * 3)
    cpu = copy.deepcopy(f32).cpu()
    t0 = time.perf_counter()
    rows = slice(0, CFG_CPU_ROWS)
    got = guided_teacher_forced(torch, f32, text[rows], prompt[:, rows],
                                runs[CFG_COEF].tokens[:, rows], TF_STEPS)
    ref = guided_teacher_forced(torch, cpu, text[rows].cpu(), prompt[:, rows].cpu(),
                                runs[CFG_COEF].tokens[:, rows].cpu(), TF_STEPS)
    print(f"  guided teacher-forced logits of {CFG_CPU_ROWS} requests (prefill + {TF_STEPS} "
          f"steps, the speaker vector on the prompt), card vs CPU, f32 "
          f"({time.perf_counter() - t0:.1f} s):")
    check("guided logits", max_err(got, ref), TOL_F32 * float(ref.abs().max()))
    del cpu
    reset_counts()
    step_took("b")

    # (c) the guided server on the f32 copy: 4 slots, 8 device rows
    reqs = [(rng.integers(3, cfg.n_txt_vocab - 1, size=TEXT_LEN), None if p == 0 else
             rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, p)), 1 + p + 2 * WINDOW)
            for p in SERVE_PROMPTS]
    srv = DecodeServer(f32, n_slots=CFG_SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW, k=1,
                       cfg_coef=CFG_COEF)
    require(srv._x_enc.shape[0] == 2 * CFG_SLOTS, "the guided server's device rows")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done, n_chunks, _ = serve(torch, srv, reqs)
    wall = time.perf_counter() - t0
    conv_shapes = {(b, t, st) for b, t, st, _ in gla_cuda.launch_shapes()["gla_chunk_conv"]}
    launches = read_counts()
    chunks = [_pow2_chunks(1 + (0 if p is None else p.shape[1])) for _, p, _ in reqs]
    print(f"(c) DecodeServer(cfg_coef={CFG_COEF}), f32 copy: {len(reqs)} requests through "
          f"{CFG_SLOTS} slots ({2 * CFG_SLOTS} rows), {n_chunks} decode chunks, {wall:.3f} s wall "
          f"[{card_line}]; launches {launches}")
    require(launches == {**dict.fromkeys(launches, 0), "gla_chunk_conv": N_GLA_LAYERS * len(reqs),
                         "gla_chunk": N_GLA_LAYERS * sum(len(c) - 1 for c in chunks),
                         "gla_decode_conv": N_GLA_LAYERS * WINDOW * n_chunks},
            f"guided server launches {launches}")
    add_launches(total, launches)
    held, f32.spk_encoder = f32.spk_encoder, None
    try:
        for rid, (txt, p, max_len) in enumerate(reqs):
            c = done[rid]
            want = generate_batch(
                f32, torch.from_numpy(txt)[None].to(DEVICE),
                prompt=None if p is None else torch.from_numpy(p)[:, None].to(DEVICE),
                max_seqlen=max_len, k=1, force_max_seqlen=True, cfg_coef=CFG_COEF)
            want = want.tokens[:, 0].T.cpu().numpy()[:c.length]
            require(np.array_equal(c.tokens, want), f"request {rid}: the server's guided "
                    f"tokens differ from generate_batch's at {np.argwhere(c.tokens != want)[:4]}")
    finally:
        f32.spk_encoder = held
    print(f"  the {len(reqs)} completions equal their own guided generate_batch token for token "
          f"(lengths {[done[r].length for r in sorted(done)]})")
    hold_f32_conv_chunks(torch, gla_cuda, conv_shapes)
    reset_counts()
    del f32, srv
    torch.cuda.empty_cache()
    step_took("c")

    # (d) the TTS pipeline, guided, at b4 with the full-width codec
    wcfg = WavTokenizerConfig()
    pipe = TTSPipeline(model, build_wavtokenizer(wcfg, seed=PIPE_CODEC_SEED), TextTokenizer())
    gen = torch.Generator(device=DEVICE).manual_seed(CFG_BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    waves, res = pipe.synthesize(PIPE_TEXT, gen, batch_size=CFG_BATCH, prompt_codes=prompt,
                                 max_seqlen=max_seqlen, cfg_coef=CFG_COEF)
    wall = time.perf_counter() - t0
    launches = read_counts()
    speech = sum(w.size for w in waves) / wcfg.sample_rate
    print(f"(d) TTSPipeline.synthesize(cfg_coef={CFG_COEF}) b{CFG_BATCH} ({T_PROMPT}-frame "
          f"prompts, top-k {TOPK}): {res.n_steps} steps, {wall * 1e3:.1f} ms wall, {speech:.3f} s "
          f"of speech, {speech / wall:.3f} s of speech a second [{card_line}]")
    print(f"  launches: {launches}")
    expect_launches(launches, gla_chunk_conv=N_GLA_LAYERS,
                    gla_decode_conv=N_GLA_LAYERS * (res.n_steps - n_pre))
    add_launches(total, launches)
    for i, (wav, (c, _)) in enumerate(zip(waves, cut_outputs(res, cfg.n_quant))):
        n = c.shape[-1]
        require(n > 0 and wav.shape == (n * wcfg.hop_length,) and bool(np.isfinite(wav).all())
                and float(np.abs(wav).max()) > 0, f"row {i}: waveform {wav.shape} for {n} frames")
    print(f"  every waveform finite, non-zero, frames x {wcfg.hop_length} long")
    step_took("d")
    del pipe, model
    torch.cuda.empty_cache()
    print(f"CFG phase took {time.perf_counter() - started:.1f} s")
    return total


def transformer_phase(torch, np, card_line):
    """The softmax transformer at the flagship's width (phase 16 of the
    module docstring). Returns the launch counts of its main-path runs."""
    import copy

    from lina_speech_tpu_torch.config import build_model
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.generate import generate_batch
    from lina_speech_tpu_torch.models.base_blocks import sdpa
    from lina_speech_tpu_torch.serving import DecodeServer
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step)

    started = time.perf_counter()
    last = [started]

    def step_took(step):
        now = time.perf_counter()
        print(f"  ({step}) took {now - last[0]:.1f} s")
        last[0] = now

    cfg = variant_cfg("transformer")
    model = build_model(cfg, device=DEVICE, seed=0)
    rnn = model.attentive_rnn
    n_params = sum(p.numel() for p in model.parameters())
    print(f"transformer: {n_params:,} parameters, {len(rnn.blocks)} blocks of {rnn.heads} heads, "
          f"cross-attention after block {rnn.cross_att_layers}, KV buffers of {rnn.max_seqlen} "
          f"positions, bf16 compute")
    require(len(rnn.blocks) == N_TRANSFORMER_BLOCKS and rnn.cross_att_layers == (6,)
            and rnn.d_model == D_MODEL, "transformer structure")
    rng = np.random.default_rng(16)
    text = torch.from_numpy(rng.integers(3, cfg.n_txt_vocab, size=(BATCH, TEXT_LEN))).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.n_codebook, size=(1, BATCH, T_PROMPT))).to(DEVICE)
    n_pre = T_PROMPT + 1
    reset_counts()
    total = dict.fromkeys(read_counts(), 0)

    # (a) generate at b8: plain PyTorch throughout on float weights
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = generate_batch(model, text, gen, prompt=prompt, max_seqlen=n_pre + TRANSFORMER_STEPS,
                         k=TOPK, force_max_seqlen=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"(a) transformer generate_batch: {BATCH} requests, {res.n_steps} steps "
          f"({TRANSFORMER_STEPS} decoded), {wall:.3f} s wall, {wall * 1e3 / TRANSFORMER_STEPS:.2f} "
          f"ms a decoded step with the prefill [{card_line}]")
    expect_launches(read_counts())
    require(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < model.n_target_vocab,
            "transformer tokens out of range")
    with torch.no_grad(), model.using_params(model.cast_param_copies()):
        x_enc = model.encode_text(text)
        y = model.embed_tokens(res.tokens[:, :, :n_pre + TF_STEPS])
        st = model.prefill(y[:, :n_pre], x_enc, model.empty_state(BATCH, DEVICE))[2]
        step = lambda: model.decode_step(y[:, n_pre], x_enc, st)
        dec_eager = eager_ms(step, 10)
        # the cross-attention's analytic rotary frequencies are made on the
        # host every call, so a decode step cannot be captured in a CUDA
        # graph: its device time comes from the profiler
        profiled(torch, lambda: [step() for _ in range(4)],
                 f"transformer decode_step b{BATCH}, 4 calls", top=8)
        q = torch.randn(BATCH, rnn.heads, 1, D_MODEL // rnn.heads, device=DEVICE,
                        dtype=model.dtype)
        kv = st.layers[0]
        mask = (torch.arange(rnn.max_seqlen, device=DEVICE) <= n_pre)[None, None, None]
        att_ms = device_ms(lambda: sdpa(q, kv.k, kv.v, mask=mask), 20)
    kv_bytes = N_TRANSFORMER_BLOCKS * nbytes(kv.k, kv.v)
    print(f"  decode step b{BATCH}: eager {dec_eager:.3f} ms (CUDA events, host dispatch "
          f"included) [{card_line}]")
    print(f"  the fixed {rnn.max_seqlen}-position KV read: sdpa over one layer's buffers "
          f"{att_ms:.4f} ms device, x {N_TRANSFORMER_BLOCKS} layers = "
          f"{att_ms * N_TRANSFORMER_BLOCKS:.3f} ms a token; {kv_bytes} bytes of k and v a token, "
          f"bound {kv_bytes / PEAK_BYTES * 1e3:.4f} ms by bytes [{card_line}]")
    step_took("a")

    # (b) teacher-forced logits and KV caches of an f32 copy, card vs CPU
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"), device=DEVICE, seed=0)
    cpu = copy.deepcopy(f32).cpu()

    def forced_run(m, dev):
        with torch.no_grad():
            x_enc = m.encode_text(text.to(dev))
            y = m.embed_tokens(res.tokens[:, :, :n_pre + TF_STEPS].to(dev))
            lg, _, st = m.prefill(y[:, :n_pre], x_enc, m.empty_state(BATCH, dev))
            out = [lg[:, -1]]
            for i in range(TF_STEPS):
                lg, _, st = m.decode_step(y[:, n_pre + i], x_enc, st, time_step=n_pre + i)
                out.append(lg)
        return torch.stack(out, 1).float().cpu(), st

    t0 = time.perf_counter()
    (got, st_k), (ref, st_c) = forced_run(f32, DEVICE), forced_run(cpu, "cpu")
    print(f"(b) transformer teacher-forced (prefill b{BATCH} t{n_pre} + {TF_STEPS} steps), f32, "
          f"card vs CPU ({time.perf_counter() - t0:.1f} s):")
    check("logits", max_err(got, ref), TOL_F32 * float(ref.abs().max()))
    worst = 0.0
    for i, (a, r) in enumerate(zip(st_k.layers, st_c.layers)):
        require(a.t == r.t == n_pre + TF_STEPS, f"layer {i}: KV clock {a.t}")
        for name in ("k", "v"):
            err = max_err(getattr(a, name).cpu(), getattr(r, name))
            scale = float(getattr(r, name).abs().max())
            require(err <= TOL_F32 * scale, f"layer {i} {name}: {err} > {TOL_F32} x {scale}")
            worst = max(worst, err / scale)
    print(f"  KV caches of the {len(st_c.layers)} layers: worst max_abs_err / max|ref| "
          f"{worst:.3e} (tolerance {TOL_F32:.0e}); clocks {n_pre + TF_STEPS}")
    step_took("b")

    # (c) int8 weights at b1: the decode loop's products through the kernels
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res_q = generate_batch(model, text[:1], gen, prompt=prompt[:, :1],
                           max_seqlen=n_pre + TRANSFORMER_Q_STEPS, k=TOPK,
                           force_max_seqlen=True, weight_quant="int8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"(c) transformer generate_batch(weight_quant=\"int8\") b1: {TRANSFORMER_Q_STEPS} "
          f"decoded, {wall:.3f} s wall [{card_line}]; launches {launches}")
    expect_launches(launches, int8_linear=TRANSFORMER_INT8_LINEARS * TRANSFORMER_Q_STEPS,
                    fused_ffn_int8=N_TRANSFORMER_BLOCKS * TRANSFORMER_Q_STEPS)
    require(int(res_q.tokens.min()) >= 0 and int(res_q.tokens.max()) < model.n_target_vocab,
            "int8 transformer tokens out of range")
    add_launches(total, launches)
    hold_launched_q_shapes(torch)
    step_took("c")

    # (d) training: f32 forward and backward at b2 t128 against the CPU,
    # one optimizer step, then two timed bf16 steps at b8 t512
    small = next(synthetic_tts_batches(
        batch_size=2, n_quant=cfg.n_quant, n_codebook=cfg.n_codebook,
        min_audio_len=TRANSFORMER_TRAIN_T, max_audio_len=TRANSFORMER_TRAIN_T, seed=1))
    loss_k, grads_k = model_grads(torch, f32, batch_to_device(small, DEVICE))
    loss_c, grads_c = model_grads(torch, cpu, batch_to_device(small, "cpu"))
    print(f"(d) transformer training forward and backward, f32, b2 t{TRANSFORMER_TRAIN_T}, card "
          f"vs CPU: loss {loss_k:.6f} vs {loss_c:.6f}")
    check("loss", abs(loss_k - loss_c), TOL_F32 * abs(loss_c))
    check_grads("parameter gradients, card vs CPU", {n: g.cpu() for n, g in grads_k.items()},
                grads_c, TOL_F32, worst=6, named=("cross_att", "qkv"),
                skip=lambda leaf: zero_gradient_mask(torch, leaf, grads_c[leaf]))
    del grads_k, grads_c, cpu
    # no warmup: the first step of a warmup runs at learning rate 0
    state = create_train_state(f32, TrainConfig(n_warmup_steps=0, n_training_steps=10))
    start = {n: p.detach().clone() for n, p in f32.named_parameters()}
    train_gen = torch.Generator(device=DEVICE).manual_seed(0)
    state, metrics = make_train_step(f32)(state, batch_to_device(small, DEVICE), train_gen)
    moved = sum(not torch.equal(p, start[n]) for n, p in f32.named_parameters())
    print(f"  one optimizer step (f32): loss {float(metrics['loss']):.6f}, grad_norm "
          f"{float(metrics['grad_norm']):.4f}; {moved} of {len(start)} parameter tensors moved")
    require(state.step == 1 and math.isfinite(float(metrics["grad_norm"])) and moved == len(start),
            "the f32 optimizer step")
    del f32, state, start
    torch.cuda.empty_cache()
    state = create_train_state(model, TrainConfig(n_warmup_steps=2, n_training_steps=100))
    train_step = make_train_step(model)
    batches = synthetic_tts_batches(batch_size=TRAIN_BATCH, n_quant=cfg.n_quant,
                                    n_codebook=cfg.n_codebook, min_audio_len=TRANSFORMER_TIMED_T,
                                    max_audio_len=TRANSFORMER_TIMED_T, seed=0)
    for i in range(2):
        batch = batch_to_device(next(batches), DEVICE)
        frames = int(batch["y_mask"].sum())
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, train_gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect_launches(read_counts())
        print(f"  bf16 train step {i} b{TRAIN_BATCH} t{batch['y_mask'].shape[1]}: loss "
              f"{float(metrics['loss']):.4f}, {ms:.1f} ms, {frames} frames -> "
              f"{frames / ms * 1e3:.0f} frames/s [{card_line}]")
        require(math.isfinite(float(metrics["loss"])), f"bf16 step {i}: loss not finite")
    del state, train_step
    model.eval()
    step_took("d")

    # (e) the server refuses the backbone: one KV clock for the whole batch
    try:
        DecodeServer(model, n_slots=2, max_text_len=MAX_TEXT_LEN, chunk=WINDOW)
        raise AssertionError("DecodeServer took the transformer")
    except ValueError as err:
        require("per-slot state" in str(err), f"DecodeServer raised {err}")
        print(f"(e) DecodeServer(transformer) raises ValueError: {err}")
    del model
    torch.cuda.empty_cache()
    print(f"transformer phase took {time.perf_counter() - started:.1f} s")
    return total


PHASE_SECONDS = []


def phase(fn, *args):
    """``fn(*args)``, its seconds noted in PHASE_SECONDS and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS.append((fn.__name__, time.perf_counter() - t0))
    print(f"[phase {fn.__name__} took {PHASE_SECONDS[-1][1]:.1f} s]")
    return out


def main():
    import numpy as np
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on a GPU only")
    from lina_speech_tpu_torch.ops import _build, gla_cuda, mamba_cuda, rwkv6_cuda

    global SFU_RATE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(card_line)
    SFU_RATE = sfu_rate(torch)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    path = _build.build()
    _build.load_library()
    built = (f"built by nvcc in {_build.build_seconds:.2f} s"
             if _build.build_seconds is not None else "reused from an earlier build")
    print(f"kernels {built}: {os.path.relpath(path, ROOT)}")
    for line in ptxas_summary(_build.build_log):
        print(f"  ptxas {line}")

    summary = phase(kernel_phase, torch, gla_cuda)
    phase(chunk_kernel_phase, torch, gla_cuda, summary)
    phase(lazy_kernel_phase, torch, gla_cuda, summary)
    phase(lazy_route_sweep, torch, gla_cuda, card_line)
    phase(fold_route_sweep, torch, gla_cuda, card_line)
    phase(decode_route_sweep, torch, gla_cuda, card_line)
    model, cfg, launches = phase(generate_phase, torch, np, gla_cuda, card_line)
    add_launches(launches, phase(serving_phase, torch, np, gla_cuda, model, cfg, card_line))
    add_launches(launches, phase(pipeline_phase, torch, np, model, cfg, card_line))
    phase(quant_linear_kernel_phase, torch, summary)
    phase(quant_lazy_kernel_phase, torch, gla_cuda, summary)
    add_launches(launches, phase(quant_generate_phase, torch, np, model, cfg, card_line))
    phase(int4_kernel_phase, torch, gla_cuda, summary)
    add_launches(launches, phase(int4_generate_phase, torch, np, model, cfg, card_line))
    add_launches(launches, phase(quant_serving_phase, torch, np, model, cfg, card_line))
    del model
    torch.cuda.empty_cache()
    phase(bwd_kernel_phase, torch, gla_cuda, summary)
    model, cfg, train_launches, _ = phase(training_phase, torch, np, gla_cuda, card_line)
    add_launches(launches, train_launches)
    add_launches(launches, phase(tuning_phase, torch, np, gla_cuda, model, cfg, card_line))
    del model, _
    torch.cuda.empty_cache()
    add_launches(launches, phase(cli_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(data_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(remat_phase, torch, np, gla_cuda, card_line))
    phase(codec_gan_phase, torch, card_line)
    phase(launched_shapes_phase, torch, gla_cuda)
    phase(chunk_bwd_kernel_phase, torch, gla_cuda, summary)
    phase(decode_kernel_phase, torch, gla_cuda, summary)
    add_launches(launches, phase(simple_gla_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(mamba2_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(interleaved_and_pp_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(cfg_spk_phase, torch, np, gla_cuda, card_line))
    add_launches(launches, phase(transformer_phase, torch, np, card_line))
    phase(launched_gla_shapes_phase, torch, gla_cuda)
    gaps = phase(gap_phase, torch, gla_cuda, card_line)
    phase(rwkv6_kernel_phase, torch, rwkv6_cuda, summary, card_line)
    add_launches(launches, phase(rwkv6_phase, torch, np, gla_cuda, card_line))
    phase(launched_rwkv6_shapes_phase, torch, rwkv6_cuda)
    gaps.update(phase(rwkv6_gap_phase, torch, rwkv6_cuda, card_line))
    phase(mamba_kernel_phase, torch, mamba_cuda, summary)
    phase(mamba_fwd_route_sweep, torch, mamba_cuda, card_line)
    phase(mamba_bwd_route_sweep, torch, mamba_cuda, card_line)
    add_launches(launches, phase(mamba_phase, torch, np, gla_cuda, card_line))
    phase(launched_mamba_shapes_phase, torch, mamba_cuda)
    gaps.update(phase(mamba_gap_phase, torch, mamba_cuda, card_line))
    kernels = []
    for name, source, replaces in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], **summary[name],
                            shapes=OTHER_SHAPES.get(name, [])))
    # launches x (time - bound): the two GLA forwards, gla_chunk's backward,
    # the four decode steps, the two folds, rwkv6_chunk and its backward and
    # the two Mamba kernels over every launched shape, the other kernels at
    # their row's shape
    gaps.update({k["name"]: k["launches"] * (k["ms"] - k["bound_ms"]) for k in kernels
                 if k["name"] not in gaps})
    print("launches x (time - bound), ms, largest first (the two GLA forwards, gla_chunk_bwd, "
          "the four decode steps, the two folds, rwkv6_chunk and its backward and the two Mamba "
          "kernels over every launched shape, the others at their row's shape):")
    for name, gap in sorted(gaps.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {gap:.3f}")
    print("seconds of each phase main called:")
    for name, sec in PHASE_SECONDS:
        print(f"  {name}: {sec:.1f}")
    print(f"chip_smoke wall time {time.perf_counter() - started:.1f} s [{card_line}]")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
