"""Evaluation: TREC topic/qrel/run I/O, trec_eval-style metrics
(``metrics``) and paired significance tests (``significance``)."""
