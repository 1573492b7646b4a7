"""PyTorch + CUDA port of lina_speech_tpu for NVIDIA Hopper (H100).

Same module layout and names as the JAX package; imports torch and numpy,
never jax or flax. Ported so far: the flagship Lina-GLA path that generates
and serves (config, model, prefill, the classic and lazy-window token
loops of generate.py, the continuous-batching DecodeServer of serving.py)
with hand-written CUDA kernels for its five GLA kernels (ops/gla_cuda.py,
csrc/).
"""
