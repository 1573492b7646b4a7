"""PyTorch + CUDA port of lina_speech_tpu for NVIDIA Hopper (H100).

Same module layout and names as the JAX package; imports torch and numpy,
never jax or flax, and nothing of the JAX package. Ported so far: the
flagship Lina-GLA paths that generate, serve and train (config, model,
prefill, the classic and lazy-window token loops of generate.py, the
continuous-batching DecodeServer of serving.py, the train step of
train/harness.py and the initial-state tuning of train/initial_state.py,
on batches from data/) with hand-written CUDA kernels for the GLA kernels of
those paths, the backward of the conv-fused prefill among them
(ops/gla_cuda.py, csrc/).
"""
