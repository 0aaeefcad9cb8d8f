"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Same sub-package layout as the JAX package, so each module's
counterpart sits at the same relative path. The port imports ``torch``
and ``numpy`` only — never ``jax``, never ``repro``. Parameter pytrees
are plain nested ``dict``s of tensors with the reference's keys and
(sorted-key) leaf order; every entry point takes an explicit ``device``
and defaults to the GPU (``repro_torch.device.resolve_device``).
"""
