"""PyTorch/CUDA port of the ``repro`` LM stack, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module (``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``) and never imports it, nor
``jax``.  Every Pallas TPU kernel on a ported path is a CUDA C++ kernel
under ``kernels/csrc/``, built with ``nvcc`` at first use.

Entry points take an explicit ``device`` that defaults to ``"cuda"``;
they run on the CPU only when the caller passes ``device="cpu"``.
"""
