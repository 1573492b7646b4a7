"""Spectral ops: ISTFT with "same" padding (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/spectral.py`` (reference
decoder/spectral_ops.py:7-75, a custom ISTFT because ``torch.istft`` cannot
do "same" padding). The inverse real FFT is ``torch.fft.irfft`` (the JAX
package spells it as two real basis matmuls only because its TPU backend
lacks complex64), and both the overlap-add and the window envelope are an
``F.fold`` over the static frame positions, the envelope folded from the
squared window in float64 on the spectrum's device. Every op is a
fixed-shape device op with no host round trip and no atomics, so a decode
is deterministic and can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F


def istft_same(spec: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
               n_fft: int, hop_length: int, win_length: int = None) -> torch.Tensor:
    """Inverse STFT with "same" padding.

    spec: (B, n_fft//2+1, T) complex spectrogram, or a (real, imag) pair of
    float tensors of that shape. Returns the (B, T*hop) f32 waveform with
    ``pad = (win - hop) // 2`` trimmed from each end, as the reference's
    (T-1)*hop + win output minus its padding.
    """
    win_length = win_length or n_fft
    re, im = spec if isinstance(spec, tuple) else (spec.real, spec.imag)
    b, _, t = re.shape
    # periodic Hann, np.hanning(win + 1)[:-1]
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float64, device=re.device)
    frames = torch.fft.irfft(torch.complex(re.float(), im.float()), n=n_fft, dim=1)
    out_len = (t - 1) * hop_length + win_length

    def overlap_add(x):  # (B, win, T) -> (B, out_len)
        return F.fold(x, output_size=(1, out_len), kernel_size=(1, win_length),
                      stride=(1, hop_length)).reshape(x.shape[0], out_len)

    y = overlap_add(frames * window.float()[:, None])
    env = overlap_add((window ** 2)[None, :, None].expand(1, win_length, t).contiguous())
    env = env.clamp_min(1e-11).float()
    pad = (win_length - hop_length) // 2
    return (y / env)[:, pad:out_len - pad]
