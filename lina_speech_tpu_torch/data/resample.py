"""Audio resampling for the data pipeline (host-side numpy).

The port's own copy of ``lina_speech_tpu/data/resample.py``: polyphase
resampling through ``scipy.signal.resample_poly`` (the reference's codec
dataset resamples with torchaudio, decoder/dataset.py:44-84). This is
input-pipeline work, not device compute.
"""
from __future__ import annotations

from math import gcd

import numpy as np


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """(..., T) waveform resampled with a polyphase filter, in its own dtype."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(
        np.asarray(audio).dtype)
