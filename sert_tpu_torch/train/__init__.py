"""Training-side modules (port of ``sert_tpu/train``): the dense step and
its optimizers (``step``), the epoch loop (``loop``) and the checkpoint
format (``checkpoint``)."""
