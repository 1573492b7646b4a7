"""The WavTokenizer codec (PyTorch port of ``lina_speech_tpu/codec``): the
SEANet encoder and VQ for prompt tokenization, the Vocos backbone and ISTFT
head for synthesis. The codec training stack is ROADMAP.md Queue 1 item 10."""
from lina_speech_tpu_torch.codec.heads import ISTFTHead
from lina_speech_tpu_torch.codec.seanet import SEANetEncoder
from lina_speech_tpu_torch.codec.spectral import istft_same
from lina_speech_tpu_torch.codec.vocos import ConvNeXtBlock, VocosBackbone
from lina_speech_tpu_torch.codec.vq import VectorQuantizer, vq_decode, vq_encode
from lina_speech_tpu_torch.codec.wavtokenizer import (
    WavTokenizer, WavTokenizerConfig, build_wavtokenizer, vocode_streaming,
)
