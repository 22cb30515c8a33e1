"""Training-side modules (port of ``sert_tpu/train``): the checkpoint
format today."""
