"""PyTorch model modules (counterparts of lina_speech_tpu.models)."""
