"""sert_tpu_torch: the PyTorch / CUDA port of sert_tpu for the NVIDIA H100.

The JAX package ``sert_tpu`` stays the reference; this package mirrors its
module names (``models/``, ``ops/``, ``scoring/``, ``train/``,
``data/feeder``, ``pipeline``, ``serving``, ``cli``) so each module's
counterpart is found by name. It imports ``torch`` and never ``jax``, and
nothing of ``sert_tpu``: the host code it shares with the reference
(``data/``, ``eval/``, ``native/``, ``recipes``, ``utils/config``,
``utils/logging``) is its own copy, with the same on-disk formats, so each
package reads the other's data dirs, recipes, checkpoints and runs.

What runs today is every model family end to end: prepare, training
(log-linear and ``lse_full`` with the full softmax through K5/K6, LSE with
the sampled softmax through K1/K2; dense adam/adagrad/sgd, epoch
snapshots, exact resume), and serving (checkpoint -> query reps -> the K3
score + bin-max sweep -> bin top-k -> the K4 gather-rescore -> final
top-k, and for log-linear the exact normalizer through K5), behind
``pipeline``, ``EntitySearcher`` and ``python -m sert_tpu_torch``. Every
Pallas kernel on those paths is a CUDA C++ kernel for sm_90a in
``csrc/``, built at first use by ``ops/_build.py``. Entry points run on
the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
