"""Visualization helpers: cross-attention alignment maps, mel spectrograms.

Counterpart of ``lina_speech_tpu/utils/viz.py``: the reference surfaces
attention maps for alignment debugging (crossatt.py:203-209); these render
``GenerateResult.att`` or a training step's attention. They take numpy
arrays or tensors (moved to the CPU here). matplotlib is imported inside
each function, never when this module is imported: a machine without it
(the GPU hosts) imports the port all the same.
"""
from __future__ import annotations

import numpy as np


def _array(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch.Tensor, on any device
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def attention_figure(att, title: str = "cross-attention"):
    """att: (heads, T, M) or (T, M) -> matplotlib figure, one panel a head."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    att = _array(att)
    if att.ndim == 2:
        att = att[None]
    h = att.shape[0]
    fig, axes = plt.subplots(1, h, figsize=(4 * h, 4), squeeze=False)
    for i in range(h):
        axes[0][i].imshow(att[i].T, origin="lower", aspect="auto", interpolation="nearest")
        axes[0][i].set_xlabel("audio step")
        axes[0][i].set_ylabel("text position")
        axes[0][i].set_title(f"{title} [head {i}]")
    fig.tight_layout()
    return fig


def save_attention(att, path: str, title: str = "cross-attention") -> None:
    attention_figure(att, title).savefig(path, dpi=120)


def mel_figure(mel, title: str = "mel"):
    """mel: (n_mels, T) log-mel -> figure (the reference logs these during
    vocoder training, experiment.py:195-216)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(_array(mel), origin="lower", aspect="auto")
    ax.set_title(title)
    fig.tight_layout()
    return fig
