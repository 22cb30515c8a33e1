"""Model families in PyTorch (port of ``sert_tpu/models``): the LSE
inference path today. Params are a dict of tensors in the reference's keys
and layouts."""
