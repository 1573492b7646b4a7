"""End-to-end TTS pipeline: text -> codec tokens -> waveform (PyTorch port).

Counterpart of ``lina_speech_tpu/pipeline.py`` (the reference's
InferenceLina flow, modeling_lina.py:111-192 + decoder/pretrained.py:
209-239): BPE-encode the text, generate codec tokens (optionally continuing
a voice-clone prompt, or from a tuned initial state), cut each row at its
stop token and vocode it with the WavTokenizer; :meth:`TTSPipeline.
tokenize_audio` goes the other way for prompts, and
:meth:`TTSPipeline.stream_synthesize` yields audio while a one-slot
``DecodeServer`` still generates.

The model and the codec run where their parameters are (``build_model`` and
``build_wavtokenizer`` put them on the GPU unless the CPU is asked for);
nothing moves to another device on its own. Waveforms come back as f32
numpy arrays on the host.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import TYPE_CHECKING, Generator, List, Optional, Tuple

import numpy as np
import torch

from lina_speech_tpu_torch.codec.wavtokenizer import WavTokenizer
from lina_speech_tpu_torch.data.tokenizer import TextTokenizer
from lina_speech_tpu_torch.generate import GenerateResult, cut_outputs, generate_batch
from lina_speech_tpu_torch.models.lina import LinaModel

if TYPE_CHECKING:
    from lina_speech_tpu_torch.serving import Completion


@dataclasses.dataclass
class TTSPipeline:
    model: LinaModel
    wavtok: WavTokenizer
    tokenizer: TextTokenizer

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def tokenize_audio(self, audio) -> torch.Tensor:
        """(B, T) waveform (array or tensor) -> (n_q, B, T') codec codes on
        the codec's device (prompt preparation)."""
        audio = torch.as_tensor(audio, dtype=torch.float32, device=self.wavtok.device)
        return self.wavtok.encode(audio)[1]

    @torch.no_grad()
    def synthesize(
        self,
        text: str,
        generator: Optional[torch.Generator] = None,
        batch_size: int = 1,
        prompt_audio=None,
        prompt_codes=None,
        init_state=None,
        max_seqlen: int = 1000,
        k: int = 100,
        temp: float = 1.0,
        cfg_coef: Optional[float] = None,
    ) -> Tuple[List[np.ndarray], GenerateResult]:
        """Returns (one waveform per row, the raw ``GenerateResult``).

        ``generator`` drives the top-k sampling (a ``torch.Generator`` on the
        model's device; None with ``k=1``). A voice-clone prompt comes as
        audio (tokenized here) or as (n_q, B or 1, p) codes; a prompt of one
        row is repeated over the batch. A row cut to no frames gives an
        empty waveform; every other row is vocoded alone (B = 1), as the
        rows have their own lengths. ``cfg_coef`` turns on classifier-free
        guidance (``generate_batch``; a model trained with ``mask_text_p >
        0``).
        """
        dev = self.device
        ids = torch.tensor(self.tokenizer.encode(text), dtype=torch.long, device=dev)
        x = ids[None].repeat(batch_size, 1)
        if prompt_audio is not None and prompt_codes is None:
            prompt_codes = self.tokenize_audio(prompt_audio)
        if prompt_codes is not None:
            prompt_codes = torch.as_tensor(prompt_codes, device=dev)
            if prompt_codes.shape[1] != batch_size:
                prompt_codes = prompt_codes.repeat_interleave(batch_size, dim=1)
        res = generate_batch(self.model, x, generator, prompt=prompt_codes,
                             init_state=init_state, max_seqlen=max_seqlen, k=k, temp=temp,
                             cfg_coef=cfg_coef)
        waves = []
        for codes, _ in cut_outputs(res, n_quant=self.model.n_quant,
                                    n_special_token_in=self.model.n_special_token_in):
            if codes.shape[-1] == 0:
                waves.append(np.zeros((0,), np.float32))
                continue
            wav = self.wavtok.codes_to_audio(torch.from_numpy(codes).to(self.wavtok.device))
            waves.append(wav[0].cpu().numpy())
        return waves, res

    def stream_synthesize(
        self,
        text: str,
        max_seqlen: int = 1000,
        k: int = 100,
        temp: float = 1.0,
        window: int = 60,
        context: int = 64,
        chunk: int = 16,
        max_text_len: int = 64,
        seed: int = 0,
        prompt_codes=None,
        cfg_coef: Optional[float] = None,
    ) -> Generator[np.ndarray, None, Completion]:
        """Streaming TTS: yield (1, window*hop) waveform chunks WHILE tokens
        generate.

        A one-slot ``DecodeServer`` decodes ``chunk`` tokens a call; between
        calls every window of ``window`` frames with ``context`` frames of
        lookahead behind it is vocoded over the same clamped slice as
        :func:`codec.wavtokenizer.vocode_streaming`, so the concatenated
        chunks equal its output on the final codes. The last chunks flush
        what remains once generation stops. ``prompt_codes``: optional
        (n_q, p) voice-clone codes. The generator's return value (its
        ``StopIteration`` value) is the server's ``Completion`` of the
        request, whose tokens ``undelay_stream`` turns into the final codes.
        ``cfg_coef`` guides the server's decoding (``DecodeServer``, which
        does not run a speaker encoder on the prompt).
        """
        from lina_speech_tpu_torch.serving import DecodeServer

        srv = DecodeServer(self.model, n_slots=1, max_text_len=max_text_len, chunk=chunk,
                           k=k, temp=temp, seed=seed, cfg_coef=cfg_coef)
        rid = srv.submit(np.asarray(self.tokenizer.encode(text)), prompt=prompt_codes,
                         max_len=max_seqlen)
        q = self.model.n_quant
        hop = self.wavtok.config.hop_length
        full = window + 2 * context
        emitted = 0  # frames vocoded so far

        @torch.no_grad()
        def vocode(codes: np.ndarray, e: int, take: int, t: int) -> np.ndarray:
            s0 = min(max(0, e - context), max(0, t - full))
            seg = torch.from_numpy(codes[:, None, s0:s0 + min(full, t)]).to(self.wavtok.device)
            off = (e - s0) * hop
            return self.wavtok.codes_to_audio(seg)[:, off:off + take * hop].cpu().numpy()

        # a request waits in the queue until run() refills, so active is 0
        # right after submit: loop on completion, not on active
        done = srv.run(max_chunks=1)
        while not done:
            part = srv.partials().get(rid)
            if part is not None:
                codes = undelay_stream(part, q, stopped=False)
                # emit every window whose lookahead exists; the live edge
                # waits (its slice would need future frames)
                while emitted + window + context <= codes.shape[1] and codes.shape[1] >= full:
                    yield vocode(codes, emitted, window, codes.shape[1])
                    emitted += window
            done = srv.run(max_chunks=1)
        c = next(cc for cc in done if cc.rid == rid)
        codes = undelay_stream(c.tokens, q, stopped=c.stopped)
        t = codes.shape[1]
        while emitted < t:
            take = min(window, t - emitted)
            yield vocode(codes, emitted, take, t)
            emitted += take
        return c


def undelay_stream(tokens: np.ndarray, n_quant: int, stopped: bool,
                   n_special: int = 3) -> np.ndarray:
    """Raw codec codes from a SAMPLED token stream, as far as it goes.

    The sampled stream starts at delayed position 1 (the forced head token
    is position 0), so ``code_i[j] = tokens[i + j, j] - n_special``: code
    ``i`` is complete once step ``i + q - 1`` is sampled. Unlike the
    reference's cut (which drops code 0 of a sampled stream), every complete
    code is kept.

    tokens: (steps, q); returns (q, N), N = usable steps - q + 1
    (``stopped=True`` leaves out the final all-stop row first).
    """
    tokens = np.asarray(tokens)
    steps = tokens.shape[0] - (1 if stopped else 0)
    n = steps - n_quant + 1
    if n <= 0:
        return np.zeros((n_quant, 0), tokens.dtype)
    idx = np.arange(n)[None, :] + np.arange(n_quant)[:, None]  # (q, n)
    return np.take_along_axis(tokens.T, idx, axis=1) - n_special


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 24000) -> None:
    """Minimal mono PCM16 WAV writer (no soundfile dependency)."""
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    data = (x * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                      sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
