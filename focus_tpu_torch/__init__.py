"""PyTorch / CUDA port of ``focus_tpu``.

Mirrors ``focus_tpu``'s module layout (config, utils, ops, models,
datasets, engine, tools) so each module's counterpart is found under the
same name. Plain tensor code is PyTorch; the TPU kernels (the trajectory
core's forward versions and backward, the space stage, the patch-embed
tokenizer, the decode step) are hand-written CUDA kernels for Hopper under
``csrc/``, built at first use by ``ops/_build.py``.
"""
