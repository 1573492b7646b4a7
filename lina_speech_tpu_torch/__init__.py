"""PyTorch + CUDA port of lina_speech_tpu for NVIDIA Hopper (H100).

Same module layout and names as the JAX package; imports torch and numpy,
never jax or flax. The slice ported so far is the flagship Lina-GLA
generate path (config, model, prefill + token loop) with hand-written CUDA
kernels for its two GLA kernels (ops/gla_cuda.py, csrc/).
"""
