"""Audio quality metrics for vocoder validation (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/metrics.py``. The reference's
validation computes UTMOS / PESQ / periodicity when enabled
(decoder/experiment.py:220-258); those need external models and compiled
packages, so :func:`quality_metrics` always computes self-contained signal
metrics (SI-SNR, log-spectral distance, mel distance with the training
loss's mel front end) and takes the external ones as hooks
(:func:`external_metric_hooks`), attached only where their assets exist.
Audio is (B, T) f32 on any device; metrics are 0-dim tensors there.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lina_speech_tpu_torch.codec.losses import log_mel, safe_log, stft_mag


def si_snr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SNR in dB per row (higher is better)."""
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = (proj ** 2).sum(-1) / ((noise ** 2).sum(-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def log_spectral_distance(est: torch.Tensor, ref: torch.Tensor, n_fft: int = 1024,
                          hop: int = 256) -> torch.Tensor:
    """RMS distance between log power spectra per row, in dB."""
    pe = safe_log(stft_mag(est, n_fft, hop) ** 2)
    pr = safe_log(stft_mag(ref, n_fft, hop) ** 2)
    return torch.sqrt(((10 / np.log(10) * (pe - pr)) ** 2).mean(dim=(1, 2)))


def mel_distance(est: torch.Tensor, ref: torch.Tensor, sample_rate: int = 24000,
                 n_fft: int = 1024, hop: int = 256, n_mels: int = 100) -> torch.Tensor:
    """Mean absolute log-mel difference per row."""
    return (log_mel(est, sample_rate, n_fft, hop, n_mels)
            - log_mel(ref, sample_rate, n_fft, hop, n_mels)).abs().mean(dim=(1, 2))


def quality_metrics(est: torch.Tensor, ref: torch.Tensor, sample_rate: int = 24000,
                    extra_hooks: Optional[Dict[str, Callable]] = None) -> Dict[str, torch.Tensor]:
    """The validation bundle over the common length of ``est`` and ``ref``:
    SI-SNR, LSD and mel L1 averaged over the batch, plus ``name: fn(est,
    ref)`` for each of ``extra_hooks`` (UTMOS / PESQ where available)."""
    n = min(est.shape[-1], ref.shape[-1])
    est, ref = est[..., :n], ref[..., :n]
    out = {
        "si_snr_db": si_snr(est, ref).mean(),
        "lsd_db": log_spectral_distance(est, ref).mean(),
        "mel_l1": mel_distance(est, ref, sample_rate).mean(),
    }
    for name, fn in (extra_hooks or {}).items():
        out[name] = fn(est, ref)
    return out


# ------------------------------------------------- external-model hooks
def _resample_np(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler (asset-free; adequate for scoring)."""
    if sr_in == sr_out:
        return x
    n_out = int(round(x.shape[-1] * sr_out / sr_in))
    t_out = np.arange(n_out) * (sr_in / sr_out)
    i0 = np.clip(t_out.astype(np.int64), 0, x.shape[-1] - 1)
    i1 = np.clip(i0 + 1, 0, x.shape[-1] - 1)
    frac = (t_out - i0).astype(x.dtype)
    return x[..., i0] * (1 - frac) + x[..., i1] * frac


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def utmos_hook(model_path: str, sample_rate: int = 24000, model_sample_rate: int = 16000):
    """UTMOS hook from a TorchScript MOS predictor on disk, run on the CPU.

    The saved module follows the UTMOS-strong convention ``model(wav (B, T)
    f32, sr int) -> (B,) scores`` (what ``torch.hub sarulab-speech/UTMOS22``
    exports; the reference calls it per validation batch on the estimate
    only, experiment.py:229)."""
    model = torch.jit.load(model_path, map_location="cpu").eval()

    def fn(est, ref):
        del ref  # MOS needs no reference
        wav = _resample_np(_host(est), sample_rate, model_sample_rate)
        with torch.no_grad():
            score = model(torch.from_numpy(np.ascontiguousarray(wav)), model_sample_rate)
        return torch.tensor(float(np.asarray(score, np.float32).mean()))

    return fn


def pesq_hook(sample_rate: int = 24000, mode: str = "wb"):
    """PESQ hook through the compiled ``pesq`` package (ITU-T P.862), if it
    imports (``ImportError`` otherwise: the caller gates). Audio is
    resampled to 16 kHz wideband (8 kHz narrowband), as the reference does
    (experiment.py:239-246)."""
    from pesq import pesq as _pesq

    target_sr = 16000 if mode == "wb" else 8000

    def fn(est, ref):
        e = _resample_np(_host(est), sample_rate, target_sr)
        r = _resample_np(_host(ref), sample_rate, target_sr)
        scores = [_pesq(target_sr, r[i], e[i], mode) for i in range(e.shape[0])]
        return torch.tensor(float(np.mean(scores, dtype=np.float32)))

    return fn


def external_metric_hooks(utmos_path: Optional[str] = None,
                          sample_rate: int = 24000) -> Dict[str, Callable]:
    """UTMOS where a checkpoint path is given and PESQ where the package
    imports; what is absent is left out, so validation runs without the
    assets. A given UTMOS path that fails to load is a user error: it warns
    (as the JAX package does) and the metric is left out."""
    hooks: Dict[str, Callable] = {}
    if utmos_path:
        try:
            hooks["utmos"] = utmos_hook(utmos_path, sample_rate)
        except Exception as e:
            warnings.warn(f"utmos hook disabled: {type(e).__name__}: {e}")
    try:
        hooks["pesq"] = pesq_hook(sample_rate)
    except ImportError:
        pass
    return hooks
