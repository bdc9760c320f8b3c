"""longterm360fov_tpu_torch — the PyTorch and CUDA port of longterm360fov_tpu.

Long-term 360° field-of-view prediction for one NVIDIA H100: the serve path
of preset ``seq2seq-tf-30`` (normalize → fused encode + autoregressive decode
→ denormalize → yaw/pitch → tile-prefetch mask) in PyTorch, with the Pallas
TPU kernel ``fused_serve`` rewritten by hand in CUDA for Hopper
(``csrc/fused_serve.cu``).

The JAX package ``longterm360fov_tpu`` is the reference: module names match
it one for one, and the tests hold each ported function against its JAX
counterpart. This package imports neither jax nor ``longterm360fov_tpu``;
the host code it needs is copied. The device is explicit everywhere: a
function runs where its tensors are, and nothing falls back to the CPU.
"""

__version__ = "0.1.0"
