"""sert_tpu_torch: the PyTorch / CUDA port of sert_tpu for the NVIDIA H100.

The JAX package ``sert_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``ops/``, ``scoring/``, ``train/``,
``data/feeder``, ``pipeline``, ``serving``, ``cli``) so each module's
counterpart is found by name. It imports ``torch`` and never ``jax``:
jax-free host code (``sert_tpu.data``, ``sert_tpu.eval``,
``sert_tpu.recipes``, ``sert_tpu.utils.config``) is reused, and everything under
``sert_tpu.models`` / ``sert_tpu.scoring`` (whose packages import jax) is
written again here.

What runs today is the LSE family end to end: prepare (the reference's
host code), training with the sampled softmax (window reps -> candidate
gather -> the K1/K2 masked logsumexp -> dense adam/adagrad/sgd, epoch
snapshots, exact resume), and serving (checkpoint -> query reps -> the K3
score + bin-max sweep -> bin top-k -> the K4 gather-rescore -> final
top-k), behind ``pipeline``, ``EntitySearcher`` and ``python -m
sert_tpu_torch``. Every Pallas kernel on those paths is a CUDA C++ kernel
for sm_90a in ``csrc/``, built at first use by ``ops/_build.py``.
"""

__version__ = "0.1.0"
