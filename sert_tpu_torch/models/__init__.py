"""Model families in PyTorch (port of ``sert_tpu/models``): log-linear
(``loglinear``) and LSE (``lse``, with its sampled and full-softmax
objectives). Params are a dict of tensors in the reference's keys and
layouts."""
