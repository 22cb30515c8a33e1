"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: K3 ``score_binmax``, K4 ``gather_rescore``, and the exact top-k
engine built on them (``exact_topk``). ``_build`` compiles ``csrc/``."""
