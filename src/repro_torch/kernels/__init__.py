"""The port's kernels: CUDA C++ sources in ``csrc/``, built at first use."""
