"""Streaming TTS demo with the PyTorch port: audio chunks arrive while
tokens still generate.

    python examples/stream_torch.py --cpu

Builds a tiny random-init model and codec (a structure demo; load trained
weights for real speech), then streams a sentence: each line prints the
chunk index, its samples and the running latency -- time to first audio is
about (window + context) decode steps, not the whole utterance. Runs on the
GPU unless --cpu is given.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--text", default="streaming synthesis demo")
    ap.add_argument("--max-len", type=int, default=60)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--context", type=int, default=8)
    ap.add_argument("--out", default=None, help="optional WAV path")
    args = ap.parse_args()

    import numpy as np

    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny
    from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
    from lina_speech_tpu_torch.pipeline import TTSPipeline, write_wav

    device = "cpu" if args.cpu else None
    model = build_model(dataclasses.replace(lina_gla_tiny(), n_codebook=32), device=device)
    wt_cfg = WavTokenizerConfig(
        ratios=(4, 2), n_filters=2, latent_dim=16, bins=32,
        backbone_dim=32, backbone_intermediate_dim=64, backbone_layers=1,
        n_fft=16, hop_length=8)
    pipe = TTSPipeline(model, build_wavtokenizer(wt_cfg, device=device, seed=3), TextTokenizer())

    t0 = time.perf_counter()
    chunks = []
    for i, wav in enumerate(pipe.stream_synthesize(
            args.text, max_seqlen=args.max_len, k=5, seed=5,
            window=args.window, context=args.context, chunk=8)):
        dt = time.perf_counter() - t0
        chunks.append(wav[0])
        print(f"chunk {i}: {wav.shape[-1]} samples at t={dt:.2f}s"
              + ("  <- first audio" if i == 0 else ""))
    audio = np.concatenate(chunks)
    print(f"total {audio.shape[-1]} samples in {time.perf_counter() - t0:.2f}s on {pipe.device}")
    if args.out:
        write_wav(args.out, audio, wt_cfg.sample_rate)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
