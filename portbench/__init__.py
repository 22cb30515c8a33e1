"""The benchmark of ``sert_tpu_torch``, the PyTorch and CUDA port: one
harness (``run.py``) driven by the cells of ``BENCHMARK.json``."""
