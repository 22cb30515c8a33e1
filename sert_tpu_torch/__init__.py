"""sert_tpu_torch: the PyTorch / CUDA port of sert_tpu for the NVIDIA H100.

The JAX package ``sert_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``ops/``, ``scoring/``, ``train/checkpoint``,
``pipeline``, ``serving``, ``cli``) so each module's counterpart is found
by name. It imports ``torch`` and never ``jax``: jax-free host code
(``sert_tpu.data``, ``sert_tpu.eval``, ``sert_tpu.recipes``,
``sert_tpu.utils.config``) is reused, and everything under
``sert_tpu.models`` / ``sert_tpu.scoring`` (whose packages import jax) is
written again here.

What runs today is the LSE serving path: checkpoint -> query reps -> the
K3 score + bin-max sweep -> bin top-k -> the K4 gather-rescore -> final
top-k, behind ``EntitySearcher`` and ``python -m sert_tpu_torch``. Every
Pallas kernel on that path is a CUDA C++ kernel for sm_90a in ``csrc/``,
built at first use by ``ops/_build.py``.
"""

__version__ = "0.1.0"
