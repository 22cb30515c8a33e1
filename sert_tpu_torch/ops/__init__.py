"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: K1/K2 ``sampled_lse`` (sampled-softmax training), K5/K6 ``xent``
(full-softmax training and the log-linear normalizer), K3 ``score_binmax``
and K4 ``gather_rescore`` (scoring), and the exact top-k engine built on
K3/K4 (``exact_topk``). ``_build`` compiles ``csrc/``."""
