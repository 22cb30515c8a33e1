"""TREC file I/O: topics, qrels, run files.

Formats (SURVEY.md section 3.1 "TREC I/O + eval glue"):
  * qrels:  ``qid iter docno rel`` whitespace-separated
  * run:    ``qid Q0 docno rank score tag``
  * topics: classic SGML ``<top><num>...<title>...`` or simple ``qid<TAB>text``
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Tuple

_NUM_RE = re.compile(r"<num>\s*(?:Number:)?\s*([^<\s]+)", re.I)
_TITLE_RE = re.compile(r"<title>\s*(?:Topic:)?\s*(.*?)\s*(?=<|$)", re.I | re.S)
_TOP_RE = re.compile(r"<top>(.*?)</top>", re.I | re.S)


def read_topics(path: str) -> Dict[str, str]:
    """Parse TREC SGML topics; falls back to ``qid<TAB>text`` lines."""
    with open(path, errors="replace") as fh:
        content = fh.read()
    topics: Dict[str, str] = {}
    blocks = _TOP_RE.findall(content)
    if blocks:
        for block in blocks:
            num = _NUM_RE.search(block)
            title = _TITLE_RE.search(block)
            if num and title:
                topics[num.group(1).strip()] = " ".join(title.group(1).split())
        return topics
    for line in content.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split("\t", 1) if "\t" in line else line.split(None, 1)
        if len(parts) == 2:
            topics[parts[0]] = parts[1]
    return topics


def read_qrels(path: str) -> Dict[str, Dict[str, int]]:
    qrels: Dict[str, Dict[str, int]] = {}
    with open(path, errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, docno, rel = parts[0], parts[1], parts[2], parts[3]
            qrels.setdefault(qid, {})[docno] = int(rel)
    return qrels


def write_qrels(qrels: Mapping[str, Mapping[str, int]], path: str) -> None:
    with open(path, "w") as fh:
        for qid in sorted(qrels):
            for docno, rel in sorted(qrels[qid].items()):
                fh.write(f"{qid} 0 {docno} {rel}\n")


def write_run(run: Mapping[str, Iterable[Tuple[str, float]]], path: str,
              tag: str = "sert_tpu") -> None:
    """Write a run file; entries are (docno, score), ranked by trec_eval's
    canonical order (score desc, docno desc tie-break)."""
    with open(path, "w") as fh:
        for qid in sorted(run):
            entries = sorted(run[qid], key=lambda e: (e[1], e[0]), reverse=True)
            for rank, (docno, score) in enumerate(entries, start=1):
                # .17g round-trips float64 exactly: score gaps below 1e-6
                # (normalized fusions, large-E log-probs) must not collapse
                # into ties that re-rank by docno after read_run.
                fh.write(f"{qid} Q0 {docno} {rank} {score:.17g} {tag}\n")


def read_run(path: str) -> Dict[str, List[Tuple[str, float]]]:
    run: Dict[str, List[Tuple[str, float]]] = {}
    with open(path, errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, docno, _, score = parts[0], parts[1], parts[2], parts[3], parts[4]
            run.setdefault(qid, []).append((docno, float(score)))
    return run


def write_topics(topics: Mapping[str, str], path: str) -> None:
    """Write simple ``qid<TAB>text`` topics (round-trips via read_topics)."""
    with open(path, "w") as fh:
        for qid in sorted(topics):
            fh.write(f"{qid}\t{topics[qid]}\n")
