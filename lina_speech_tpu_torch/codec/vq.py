"""Vector quantization: nearest-neighbour encode and decode, and the EMA
training half (PyTorch port).

Counterpart of ``lina_speech_tpu/codec/vq.py`` (reference
encoder/quantization/vq.py, core_vq.py):

- inference: nearest-neighbour encode as one matmul and an argmax, decode as
  a sum of codebook gathers, and true residual VQ. The codebooks live in a
  :class:`VectorQuantizer` laid out as the reference's
  ``vq.layers.{i}._codebook.embed`` (bins, dim), so a reference state_dict
  loads as is;
- training: :class:`VQState` (stacked codebooks and their EMA statistics),
  :func:`kmeans_init`, :func:`expire_dead_codes`,
  :func:`ema_codebook_update` and :func:`vq_train_step` (straight-through,
  commitment loss, EMA with Laplace smoothing). Random draws take an explicit
  ``torch.Generator``; ``jax.random.choice``'s stream cannot be matched, so
  both draws also take their indices from the caller (``idx``). The JAX
  functions' ``axis_name`` (a psum over the data-parallel axis) has no
  counterpart before multi-GPU training (ROADMAP.md Queue 1 item 11): a
  value other than None raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class _Codebook(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(bins, dim))


class _Layer(nn.Module):
    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = _Codebook(bins, dim)


class VectorQuantizer(nn.Module):
    """Stacked codebooks: ``embed[i]`` is layer i's (bins, dim) f32 table."""

    def __init__(self, n_q: int, bins: int, dim: int):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(bins, dim) for _ in range(n_q)])

    @property
    def n_q(self) -> int:
        return len(self.layers)

    @property
    def embed(self) -> Tuple[torch.Tensor, ...]:
        return tuple(layer._codebook.embed for layer in self.layers)


def _nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """x: (..., d); codebook: (bins, d) -> (...) int64 indices.

    argmin |x - e|^2 == argmax (2 x.e - |e|^2): |x|^2 is the same for every
    code. The first index wins a tie, as in JAX.
    """
    score = 2.0 * x @ codebook.T - (codebook * codebook).sum(-1)
    return score.argmax(-1)


def vq_encode(x: torch.Tensor, quantizer: VectorQuantizer,
              n_q: Optional[int] = None) -> torch.Tensor:
    """x: (B, T, d) latents -> codes (n_q, B, T); every layer quantizes the
    same input (the reference's language VQ, core_vq.py:367-401)."""
    n_q = n_q if n_q is not None else quantizer.n_q
    return torch.stack([_nearest(x, quantizer.embed[i]) for i in range(n_q)])


def vq_decode(codes: torch.Tensor, quantizer: VectorQuantizer) -> torch.Tensor:
    """codes: (n_q, B, T) -> (B, T, d), the sum of the codebook vectors."""
    out = quantizer.embed[0][codes[0]]
    for i in range(1, codes.shape[0]):
        out = out + quantizer.embed[i][codes[i]]
    return out


def residual_vq_encode(x: torch.Tensor, quantizer: VectorQuantizer,
                       n_q: Optional[int] = None) -> torch.Tensor:
    """True residual VQ: each layer quantizes what the earlier ones left
    (core_vq.py's RVQ, stock EnCodec's path)."""
    n_q = n_q if n_q is not None else quantizer.n_q
    codes, residual = [], x
    for i in range(n_q):
        idx = _nearest(residual, quantizer.embed[i])
        residual = residual - quantizer.embed[i][idx]
        codes.append(idx)
    return torch.stack(codes)


# ------------------------------------------------------------ training half
@dataclasses.dataclass
class VQState:
    """Stacked codebooks and their EMA statistics (JAX ``VectorQuantizer``)."""

    embed: torch.Tensor         # (n_q, bins, dim)
    cluster_size: torch.Tensor  # (n_q, bins)
    embed_avg: torch.Tensor     # (n_q, bins, dim)

    @classmethod
    def create(cls, generator: torch.Generator, n_q: int, bins: int, dim: int,
               device=None) -> "VQState":
        """Codebooks uniform in [-1, 1), cluster sizes zero, ``embed_avg``
        the codebooks."""
        embed = (torch.rand(n_q, bins, dim, generator=generator) * 2.0 - 1.0).to(device)
        return cls(embed=embed, cluster_size=torch.zeros(n_q, bins, device=device),
                   embed_avg=embed.clone())

    @property
    def n_q(self) -> int:
        return self.embed.shape[0]


def _no_axis(name: str, axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(f"{name}(axis_name=...): the data-parallel reduction is "
                                  "not ported (ROADMAP.md Queue 1 item 11)")


def kmeans_init(generator: Optional[torch.Generator], x: torch.Tensor, bins: int,
                iters: int = 10, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means codebook init from the first batch (core_vq.py:140-151).

    x: (N, d) latents -> (bins, d) centroids, started from the rows ``idx``
    (bins,), drawn from ``generator`` when not given: distinct rows, or
    with replacement where N < bins (``jax.random.choice``'s rule). Empty
    clusters keep their centroid."""
    n, _ = x.shape
    if idx is None:
        idx = (torch.randint(n, (bins,), generator=generator) if n < bins
               else torch.randperm(n, generator=generator)[:bins])
    centroids = x[idx.to(x.device)]
    for _ in range(iters):
        assign = ((x[:, None, :] - centroids[None]) ** 2).sum(-1).argmin(1)
        onehot = F.one_hot(assign, bins).to(x.dtype)
        counts = onehot.sum(0)[:, None]
        sums = onehot.T @ x
        centroids = torch.where(counts > 0, sums / counts.clamp(min=1), centroids)
    return centroids


def expire_dead_codes(generator: Optional[torch.Generator], quantizer: VQState,
                      batch_samples: torch.Tensor, threshold: float = 2.0,
                      axis_name: Optional[str] = None,
                      idx: Optional[Sequence[torch.Tensor]] = None) -> VQState:
    """Replace the codes whose EMA cluster size fell below ``threshold`` with
    rows of the batch (core_vq.py:153-169): layer i's code j becomes row
    ``idx[i][j]`` of the flattened batch, the rows drawn with replacement
    from ``generator`` when ``idx`` is not given."""
    _no_axis("expire_dead_codes", axis_name)
    n_q, bins, dim = quantizer.embed.shape
    flat = batch_samples.reshape(-1, dim)
    new_embed = []
    for i in range(n_q):
        rows = (torch.randint(flat.shape[0], (bins,), generator=generator)
                if idx is None else idx[i])
        dead = quantizer.cluster_size[i] < threshold
        new_embed.append(torch.where(dead[:, None], flat[rows.to(flat.device)],
                                     quantizer.embed[i]))
    return dataclasses.replace(quantizer, embed=torch.stack(new_embed))


class VQTrainResult(NamedTuple):
    quantized: torch.Tensor    # straight-through quantized latents
    codes: torch.Tensor        # (n_q, B, T)
    commit_loss: torch.Tensor  # scalar commitment MSE
    quantizer: VQState


def ema_codebook_update(x: torch.Tensor, codes: torch.Tensor, quantizer: VQState,
                        decay: float = 0.99, epsilon: float = 1e-5,
                        axis_name: Optional[str] = None) -> VQState:
    """One training step's EMA update (core_vq.py:217-229): cluster sizes and
    embedding sums decay towards this batch's one-hot counts and sums, and
    the codebooks are the Laplace-smoothed averages. Returns a new state
    (no gradient flows through it). Every layer of ``quantizer`` is updated;
    with fewer layers of ``codes`` (a drawn n_q below the codebooks') the
    layers past them take the last layer's codes, as the JAX package's
    clamped indexing ``codes[i]`` gives them."""
    _no_axis("ema_codebook_update", axis_name)
    n_q, bins, dim = quantizer.embed.shape
    with torch.no_grad():
        flat = x.reshape(-1, dim).float()
        new_cs, new_avg = [], []
        for i in range(n_q):
            onehot = F.one_hot(codes[min(i, codes.shape[0] - 1)].reshape(-1), bins).float()
            new_cs.append(quantizer.cluster_size[i] * decay + onehot.sum(0) * (1 - decay))
            new_avg.append(quantizer.embed_avg[i] * decay + (onehot.T @ flat) * (1 - decay))
        cluster_size, embed_avg = torch.stack(new_cs), torch.stack(new_avg)
        n = cluster_size.sum(-1, keepdim=True)
        smoothed = (cluster_size + epsilon) / (n + bins * epsilon) * n
        return VQState(embed=embed_avg / smoothed[..., None], cluster_size=cluster_size,
                       embed_avg=embed_avg)


def vq_train_step(x: torch.Tensor, quantizer: VQState, n_q: int, decay: float = 0.99,
                  axis_name: Optional[str] = None) -> VQTrainResult:
    """Quantize with the straight-through estimator, the commitment loss and
    the EMA update (core_vq.py:294-315; the reference draws n_q from {4, 6,
    8} during training, vq.py:103-108: pass the drawn value in)."""
    _no_axis("vq_train_step", axis_name)
    codes = vq_encode(x, quantizer, n_q)
    quant = vq_decode(codes, quantizer) / max(n_q, 1)
    commit = ((quant.detach() - x) ** 2).mean()
    quant_st = x + (quant - x).detach()
    return VQTrainResult(quant_st, codes, commit,
                         ema_codebook_update(x, codes, quantizer, decay))
