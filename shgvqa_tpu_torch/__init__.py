"""shgvqa_tpu_torch: the PyTorch + CUDA port of ``shgvqa_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module paths and class names, so each
module here has its counterpart under ``shgvqa_tpu/``.  It imports ``torch``
and numpy only; it never imports ``jax``, ``flax`` or ``shgvqa_tpu`` and keeps
its own copy of what it needs from them.

Ported so far: flagship HGQA inference from uint8 frames to the answer
(``models/shgvqa.py``), with the fused FFN block as a hand-written CUDA
kernel (``csrc/ffn.cu``, wrapper ``kernels/ffn.py``).  Options the flagship
does not use raise ``NotImplementedError`` (``configs/config.check_ported``).
"""
