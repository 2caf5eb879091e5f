"""PyTorch/CUDA port of luminaai_tpu, grown slice by slice beside it.

This package imports torch, numpy and the standard library only: nothing
of JAX and nothing of the luminaai_tpu package. Its layout mirrors
luminaai_tpu so each counterpart is easy to find. Entry points run on the
card (device=None means "cuda" and raises where no CUDA device exists);
an explicit device="cpu" runs the plain PyTorch path, as the tests do.

Ported so far: the serving path of the dense model (config, byte
tokenizer, layers, transformer, slot-paged KV pool, StepwiseDecoder,
ContinuousScheduler + HTTP server), with the ragged paged decode-attention
kernel written in CUDA for Hopper (csrc/ragged_paged_attention.cu); and
its training path (fused LM-head cross-entropy, AdamW with the JAX
schedules, the accumulating train step, a trimmed Trainer, `train` on the
CLI), with the flash-attention forward and backward kernels written in
CUDA for Hopper (csrc/flash_attention.cu); and the mixture-of-experts
layer on both paths (top-k routing with per-group capacity, sort and gmm
dispatch), with the grouped matmul and its transposed form written in CUDA
for Hopper (csrc/gmm.cu).
"""

from luminaai_tpu_torch.config import Config, ConfigPresets, resolve_device

__all__ = ["Config", "ConfigPresets", "resolve_device"]
