"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``); see
``run.py`` and ``harness.py``."""
