"""The codecs (PyTorch port of ``lina_speech_tpu/codec``): the WavTokenizer
codec (the SEANet encoder and VQ for prompt tokenization, the Vocos backbone
and ISTFT head for synthesis), its GAN training (``losses``,
``discriminators``, ``gan``, ``metrics``), and the EnCodec compression stack
(``encodec``: segmented EnCodec and the ``LSTC`` container; ``lm``: the
streaming-transformer LM over codes; ``ac``: the arithmetic coder)."""
from lina_speech_tpu_torch.codec.heads import ISTFTHead
from lina_speech_tpu_torch.codec.seanet import SEANetEncoder
from lina_speech_tpu_torch.codec.spectral import istft_same
from lina_speech_tpu_torch.codec.vocos import ConvNeXtBlock, VocosBackbone
from lina_speech_tpu_torch.codec.vq import VectorQuantizer, vq_decode, vq_encode
from lina_speech_tpu_torch.codec.wavtokenizer import (
    WavTokenizer, WavTokenizerConfig, build_wavtokenizer, vocode_streaming,
)
