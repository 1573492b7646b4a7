"""Tensor ops and kernel wrappers (counterparts of lina_speech_tpu.ops)."""
