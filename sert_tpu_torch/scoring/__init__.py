"""Entity scoring engines (port of ``sert_tpu/scoring``)."""
