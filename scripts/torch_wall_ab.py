"""Wall-clock A/B of the PyTorch port's flagship on the GPU, one checkout per
process: warm train steps, a served prompt's prefill, and the host time of
one call of the GLA forward and backward kernels.

Each run imports ``lina_speech_tpu_torch`` from the checkout ``--tree``
(builds its kernels there) and prints one JSON line. Compare two checkouts
on one card by alternating their runs, each in a fresh process:

  python scripts/torch_wall_ab.py --tree parent_checkout --label parent
  python scripts/torch_wall_ab.py --tree . --label change
  python scripts/torch_wall_ab.py --tree . --label change
  python scripts/torch_wall_ab.py --tree parent_checkout --label parent

What it measures (the flagship Lina-GLA at the full width, random weights
from seed 0, bf16 compute):

- ``train_ms``: wall ms of each of ``--steps`` train steps at b8 on
  synthetic batches of audio length 128-512 (seed 0, the same batches in
  every run), after ``--warm`` steps that are not kept;
- ``prefill_ms``: host ms, synchronized, of the prefill and insertion of
  one request through ``DecodeServer`` (b1, power-of-two chunks) for each
  prompt length, ``--repeats`` times;
- ``lazy_chunk_ms``: host ms of ``--chunks`` lazy decode chunks (16 tokens)
  of that server with all 8 slots busy, each a ``run(max_chunks=1)`` call
  that ran no prefill and completed no request (it ends in a host read of
  the chunk's tokens; ``--lazy-route`` puts every lazy step of the run on
  one body);
- ``host_us``: host microseconds of one call of ``gla_chunk_conv``'s forward
  (under no_grad, on the route the package plans) and of its backward,
  from the call to its return with the card idle before it (median of 30),
  at the server's first chunk (b1 t128), generate's prefill (b8 t151) and
  the training shape (b8 t512); where the package has the forward's
  launcher with a route, the recurrent body's too (``fwd_recurrent``).
"""
import argparse
import json
import os
import statistics
import sys
import time

H, DK, DV = 4, 256, 512
TRAIN_BATCH, MIN_AUDIO, MAX_AUDIO = 8, 128, 512
SLOTS, MAX_TEXT_LEN, WINDOW, TEXT_LEN = 8, 64, 16, 32
PROMPTS = (150, 97, 33, 0)
HOST_SHAPES = ((1, 128), (8, 151), (8, 512))


def host_us(torch, fn, n=30):
    """Median host microseconds from a call of ``fn`` to its return, the card
    idle before each call."""
    out = []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out[3:])


def kernel_host_times(torch, gla_cuda):
    """{shape: {what: host us}} of the forward and backward of gla_chunk_conv."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    res = {}
    for b, t in HOST_SHAPES:
        r = lambda *s: torch.randn(*s, generator=g, device="cuda")
        xq, xk = r(b, H, t, DK).to(bf), r(b, H, t, DK).to(bf)
        xv, do = r(b, H, t, DV).to(bf), r(b, H, t, DV).to(bf)
        gk = torch.nn.functional.logsigmoid(r(b, H, t, DK)) / 16
        taps = [(r(H * d, 4) * 0.5).to(bf) for d in (DK, DK, DV)]
        s0, dsf = r(b, H, DK, DV).to(bf), r(b, H, DK, DV).to(bf)
        args = (xq, xk, xv, gk, *taps)
        times = {}
        with torch.no_grad():
            times["fwd"] = host_us(torch, lambda: gla_cuda.gla_chunk_conv(*args, initial_state=s0))
            launch = getattr(gla_cuda, "_chunk_conv_launch", None)
            if hasattr(gla_cuda, "gla_chunk_fwd_plan"):
                times["fwd_recurrent"] = host_us(
                    torch, lambda: launch(*args, s0, DK ** -0.5, "recurrent"))
        times["bwd"] = host_us(torch, lambda: gla_cuda.gla_chunk_conv_bwd(*args, s0, do, dsf))
        res[f"b{b} t{t}"] = times
    return res


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tree", required=True, help="checkout whose lina_speech_tpu_torch to run")
    p.add_argument("--label", required=True)
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--chunks", type=int, default=6)
    p.add_argument("--lazy-route", choices=("tile", "cluster"),
                   help="put every lazy step on this body instead of the plan's (a checkout "
                        "with gla_decode_lazy_plan), to part the route from the rest")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    import lina_speech_tpu_torch
    from lina_speech_tpu_torch.config import build_model, lina_gla_169m
    from lina_speech_tpu_torch.data.synthetic import synthetic_tts_batches
    from lina_speech_tpu_torch.ops import gla_cuda
    from lina_speech_tpu_torch.serving import DecodeServer
    from lina_speech_tpu_torch.train.harness import (
        TrainConfig, batch_to_device, create_train_state, make_train_step,
    )

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if not os.path.abspath(lina_speech_tpu_torch.__file__).startswith(tree + os.sep):
        sys.exit(f"imported {lina_speech_tpu_torch.__file__}, not the package under {tree}")
    if args.lazy_route:
        gla_cuda.gla_decode_lazy_plan = lambda b, h, state_dtype: args.lazy_route
    cfg = lina_gla_169m(compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)

    host = kernel_host_times(torch, gla_cuda)

    state = create_train_state(model, TrainConfig(n_warmup_steps=2, n_training_steps=100))
    step = make_train_step(model)
    batches = synthetic_tts_batches(batch_size=TRAIN_BATCH, n_quant=cfg.n_quant,
                                    n_codebook=cfg.n_codebook, min_audio_len=MIN_AUDIO,
                                    max_audio_len=MAX_AUDIO, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_ms, train_t = [], []
    for i in range(args.warm + args.steps):
        batch = batch_to_device(next(batches), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        if i >= args.warm:
            train_ms.append((time.perf_counter() - t0) * 1e3)
            train_t.append(int(batch["y_mask"].shape[1]))
        if not np.isfinite(loss):
            sys.exit(f"step {i}: loss {loss}")
    del state, step
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    srv = DecodeServer(model, n_slots=SLOTS, max_text_len=MAX_TEXT_LEN, chunk=WINDOW,
                       lazy=True, k=1)
    prefill = {}
    for p_len in PROMPTS:
        text = rng.integers(3, cfg.n_txt_vocab, size=TEXT_LEN)
        prompt = rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, p_len)) if p_len else None
        ms = []
        for _ in range(args.repeats + 1):
            srv.submit(text, prompt=prompt, max_len=p_len + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = srv.run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if len(done) != 1 or done[0].length != p_len + 1:
                sys.exit("the request did not end at its prefill")
        prefill[str(p_len)] = ms[1:]

    # lazy decode chunks at 8 busy slots: every call after the first that
    # started and ended with all slots busy and completed no request (a
    # call that refills a slot runs a prefill too)
    for _ in range(4 * SLOTS):
        text = rng.integers(3, cfg.n_txt_vocab, size=TEXT_LEN)
        prompt = rng.integers(0, cfg.n_codebook, size=(cfg.n_quant, PROMPTS[2]))
        srv.submit(text, prompt=prompt, max_len=PROMPTS[2] + 8 * WINDOW)
    lazy_chunk_ms, calls = [], 0
    while (calls == 0 or srv.active) and len(lazy_chunk_ms) < args.chunks:
        busy = srv.active
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv.run(max_chunks=1)
        ms = (time.perf_counter() - t0) * 1e3
        if calls and not out and busy == SLOTS:
            lazy_chunk_ms.append(ms)
        calls += 1

    print(json.dumps(dict(label=args.label, train_ms=train_ms, train_t=train_t,
                          prefill_ms=prefill, lazy_chunk_ms=lazy_chunk_ms, host_us=host)))


if __name__ == "__main__":
    main()
