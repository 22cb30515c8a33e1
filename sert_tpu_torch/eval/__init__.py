"""Evaluation: TREC topic/qrel/run I/O, trec_eval-style metrics
(``metrics``), paired significance tests (``significance``), run fusion
(``fuse``) and the ranker report (``report``)."""

from sert_tpu_torch.eval.fuse import fuse_runs  # noqa: F401
from sert_tpu_torch.eval.report import (  # noqa: F401
    build_ranker_runs,
    format_markdown,
    ranker_report,
)
