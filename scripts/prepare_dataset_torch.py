"""Offline audio tokenization into training shards, on the port.

The counterpart of ``scripts/prepare_dataset.py`` (the reference's flow,
SURVEY §3.4: WavTokenizer.encode_infer over a corpus, codes stored for the
TTS trainer), on ``lina_speech_tpu_torch``: each manifest line's WAV is
read, resampled to ``--sample-rate`` when its name ends in ``@<sr>.wav``,
zero-padded to a multiple of the codec's hop, and encoded by the port's
``WavTokenizer.encode`` on the card (``--cpu`` for the CPU). The codes go
into ``.npz`` shards of ``--shard-size`` utterances that
``data/dataset.py:TokenizedTTSDataset`` (and ``kind: npz`` in a training
config) reads.

Input: a manifest TSV with lines "<wav_path>\\t<transcript>".

  python scripts/prepare_dataset_torch.py --manifest files.tsv --out shards/ \\
      [--wavtok-ckpt state_dict.pt] [--seed 0] [--shard-size 512] [--cpu]

``--wavtok-ckpt`` is a state_dict of the port's ``WavTokenizer`` saved with
``torch.save`` (``utils/convert.py:load_wavtokenizer_state_dict`` turns a
reference checkpoint into one); without it the codec has random weights
drawn from ``--seed``.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def load_utterance(path: str, sample_rate: int, hop: int) -> np.ndarray:
    """The mono f32 waveform the codec encodes for ``path``: resampled from
    the ``<name>@<sr>.wav`` rate when the name gives one (WAVs are taken to
    be at ``sample_rate`` otherwise), zero-padded to a multiple of ``hop``
    so every frame is produced."""
    from lina_speech_tpu_torch.data.audio_loader import read_wav
    from lina_speech_tpu_torch.data.resample import resample

    audio = read_wav(path)
    name = os.path.basename(path)
    if "@" in name:
        audio = resample(audio, int(name.split("@")[-1].split(".")[0]), sample_rate)
    return np.pad(audio, (0, (-len(audio)) % hop))


def prepare(wavtok, manifest: str, out: str, shard_size: int = 512,
            sample_rate: int = 24000):
    """Tokenize every line of ``manifest`` with ``wavtok`` into shards under
    ``out``; returns the shard paths and the number of utterances."""
    import torch

    from lina_speech_tpu_torch.data.dataset import TokenizedTTSDataset

    os.makedirs(out, exist_ok=True)
    hop = wavtok.config.hop_length
    shards, items, n_done = [], [], 0

    def flush():
        shards.append(os.path.join(out, f"shard_{len(shards):05d}.npz"))
        TokenizedTTSDataset.save_npz(shards[-1], items)
        items.clear()

    with open(manifest) as f:
        lines = [line.rstrip("\n") for line in f]
    for line in lines:
        if not line:
            continue
        path, text = line.split("\t", 1)
        audio = torch.from_numpy(load_utterance(path, sample_rate, hop)).to(wavtok.device)
        with torch.no_grad():
            codes = wavtok.encode(audio[None])[1][:, 0]  # (n_q, T')
        items.append({"audio_token": codes.cpu().numpy(), "text": text})
        n_done += 1
        if len(items) >= shard_size:
            flush()
    if items:
        flush()
    return shards, n_done


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--wavtok-ckpt", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard-size", type=int, default=512)
    p.add_argument("--sample-rate", type=int, default=24000)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    import torch

    from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizerConfig, build_wavtokenizer

    wavtok = build_wavtokenizer(WavTokenizerConfig(), device="cpu" if args.cpu else None,
                                seed=args.seed)
    if args.wavtok_ckpt:
        wavtok.load_state_dict(torch.load(args.wavtok_ckpt, map_location=wavtok.device,
                                          weights_only=True))
    shards, n = prepare(wavtok, args.manifest, args.out, args.shard_size, args.sample_rate)
    print(f"tokenized {n} utterances into {len(shards)} shards at {args.out} "
          f"on {wavtok.device}")
    return shards


if __name__ == "__main__":
    main()
