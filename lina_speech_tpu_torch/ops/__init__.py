"""Tensor ops and kernel wrappers (counterparts of lina_speech_tpu.ops)."""
from lina_speech_tpu_torch.ops.rotary import RotaryEmbedding, apply_rotary
