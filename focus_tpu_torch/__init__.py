"""PyTorch / CUDA port of the ORViT-Motionformer eval forward.

Mirrors ``focus_tpu``'s module layout (config, utils, ops, models) so each
module's counterpart is found under the same name. Plain tensor code is
PyTorch; the two TPU kernels on this path (the fused trajectory core and
the patch-embed tokenizer) are hand-written CUDA kernels for Hopper under
``csrc/``, built at first use by ``ops/_build.py``.
"""
