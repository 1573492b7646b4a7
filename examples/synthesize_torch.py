"""Example: zero-shot TTS synthesis with the PyTorch port (+ optional
voice-clone prompt).

With random weights this produces noise -- it demonstrates the full flow
(text -> BPE -> codec tokens -> waveform). Point --lina-ckpt at a
reference-named torch state_dict and --wavtok-ckpt at a reference
WavTokenizer checkpoint for real speech. Runs on the GPU unless --cpu is
given.

  python examples/synthesize_torch.py --text "hello world" --out out.wav --cpu
"""
import argparse
import os
import sys
import wave

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def read_wav(path, sample_rate, seconds=1.0):
    """The first ``seconds`` of a mono PCM16 WAV at ``sample_rate`` as a
    (1, T) float32 array in [-1, 1)."""
    import numpy as np

    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2 or f.getframerate() != sample_rate:
            raise ValueError(f"{path}: need PCM16 at {sample_rate} Hz")
        data = np.frombuffer(f.readframes(int(seconds * sample_rate)), "<i2")
        data = data.reshape(-1, f.getnchannels())[:, 0]
    return (data.astype(np.float32) / 32768.0)[None]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--text", default="hello from the gpu")
    p.add_argument("--out", default="out.wav")
    p.add_argument("--config", default=None, help="model YAML (default tiny)")
    p.add_argument("--lina-ckpt", default=None,
                   help="torch state_dict with the reference's parameter names")
    p.add_argument("--wavtok-ckpt", default=None,
                   help="reference WavTokenizer checkpoint (torch state_dict)")
    p.add_argument("--prompt-wav", default=None, help="voice-clone prompt audio")
    p.add_argument("--max-seqlen", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import dataclasses

    import numpy as np
    import torch

    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer
    from lina_speech_tpu_torch.config import build_model, lina_gla_tiny, load_config
    from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
    from lina_speech_tpu_torch.pipeline import TTSPipeline, write_wav
    from lina_speech_tpu_torch.utils.convert import load_wavtokenizer_state_dict

    device = "cpu" if args.cpu else None
    wt_cfg = WavTokenizerConfig()
    model_cfg = (load_config(args.config)["model"] if args.config
                 else dataclasses.replace(lina_gla_tiny(), n_codebook=wt_cfg.bins))
    model = build_model(model_cfg, device=device, seed=args.seed)
    if args.lina_ckpt:
        sd = torch.load(os.path.abspath(args.lina_ckpt), map_location="cpu")
        sd = {k.removeprefix("model."): v for k, v in sd.get("state_dict", sd).items()}
        model.load_state_dict(sd, strict=False)
    wavtok = build_wavtokenizer(wt_cfg, device=device, seed=args.seed + 1)
    if args.wavtok_ckpt:
        sd = torch.load(os.path.abspath(args.wavtok_ckpt), map_location="cpu")
        load_wavtokenizer_state_dict(wavtok, sd.get("state_dict", sd))

    pipe = TTSPipeline(model, wavtok, TextTokenizer())
    prompt_audio = (read_wav(args.prompt_wav, wt_cfg.sample_rate) if args.prompt_wav
                    else None)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed + 2)
    waves, res = pipe.synthesize(args.text, gen, prompt_audio=prompt_audio,
                                 max_seqlen=args.max_seqlen)
    audio = waves[0] if waves[0].size else np.zeros(1600, np.float32)
    write_wav(args.out, audio, wt_cfg.sample_rate)
    print(f"wrote {args.out}: {waves[0].size} samples, {res.n_steps} decode steps "
          f"on {pipe.device}")


if __name__ == "__main__":
    main()
