"""Corpus parsers: TREC SGML collections and Amazon review JSON.

Reference coverage (SURVEY.md section 3.1 "Corpus parsers"): readers for
TREC-format enterprise collections (W3C, CERC — used for expert finding) and
Amazon product review data (used for LSE product search), each yielding
(doc_id, text) pairs. Association construction differs per collection:
experts are associated via candidate-mention heuristics, products own their
review/description text.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Tuple

from sert_tpu_torch.data.assoc import Associations, EntityRegistry

DocStream = Iterator[Tuple[str, str]]


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", errors="replace")
    return open(path, "r", errors="replace")


# ---------------------------------------------------------------------------
# TREC SGML (<DOC><DOCNO>id</DOCNO> ... </DOC>) — W3C / CERC style.
# ---------------------------------------------------------------------------

_DOC_RE = re.compile(r"<DOC>(.*?)</DOC>", re.S | re.I)
_DOCNO_RE = re.compile(r"<DOCNO>\s*(.*?)\s*</DOCNO>", re.S | re.I)
_TAG_RE = re.compile(r"<[^>]+>")


def iter_trec_docs(paths: Iterable[str]) -> DocStream:
    """Yield (docno, text) from TREC SGML files; tags stripped from text."""
    for path in paths:
        with _open_maybe_gzip(path) as fh:
            content = fh.read()
        for m in _DOC_RE.finditer(content):
            body = m.group(1)
            no = _DOCNO_RE.search(body)
            if not no:
                continue
            text = _TAG_RE.sub(" ", _DOCNO_RE.sub(" ", body))
            yield no.group(1), text


def trec_collection_files(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith((".sgml", ".txt", ".trectext", ".gz")):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


# ---------------------------------------------------------------------------
# Expert candidate associations (W3C/CERC style).
# ---------------------------------------------------------------------------

def load_candidate_list(path: str) -> EntityRegistry:
    """Candidate file: one expert per line, ``id<TAB>full name<TAB>email...``.
    Extra columns are alternate mentions used for association matching."""
    return load_candidates(path)[0]


def load_candidates(path: str) -> Tuple[EntityRegistry, Dict[str, List[str]]]:
    """Parse a candidates file into (registry, {candidate_id: [mentions]}).
    Column 1 is the id; later columns (names, e-mails) are the mention
    strings the association matcher searches documents for."""
    reg = EntityRegistry()
    mentions: Dict[str, List[str]] = {}
    with open(path, errors="replace") as fh:
        for line in fh:
            parts = [p.strip() for p in line.rstrip("\n").split("\t")]
            if not parts or not parts[0]:
                continue
            reg.add(parts[0])
            mentions[parts[0]] = [p for p in parts[1:] if p]
    return reg, mentions


def build_expert_associations(
    docs: Iterable[Tuple[str, str]],
    candidates: Dict[str, List[str]],
    registry: EntityRegistry,
) -> Associations:
    """Associate documents with experts by mention matching: a document is
    associated with every candidate whose name or e-mail occurs in its text
    (the reference's authorship/e-mail heuristic, SURVEY.md section 3.1).

    One combined alternation regex scans each LOWERCASED document once
    (longest mention first so overlapping mentions prefer the longer), then
    matches map back to candidates — O(docs * text) instead of the
    O(docs * candidates * mentions) of per-candidate searches, which at W3C
    scale (~330k docs x ~1.1k candidates) is the difference between minutes
    and hours.

    Matching details: case folding uses str.lower() on BOTH sides (re.I's
    simple fold can match case variants like U+0130 whose .lower() is not
    the mention key — a crash class, not just a miss); alternatives carry
    alphanumeric-boundary lookarounds so a short alias like 'Li' cannot
    match inside 'public'."""
    assoc = Associations()
    mention_to_ids: Dict[str, List[int]] = {}
    for cand_id, mentions in candidates.items():
        ent = registry.id(cand_id)
        for m in mentions:
            if m:
                mention_to_ids.setdefault(m.lower(), []).append(ent)
    if not mention_to_ids:
        return assoc
    alternation = "|".join(
        re.escape(m) for m in sorted(mention_to_ids, key=len, reverse=True))
    # \w boundaries (Unicode-aware, includes underscore): 'Li' must not
    # match inside 'Liège' or 'li_table' any more than inside 'library'.
    pattern = re.compile(r"(?<!\w)(?:" + alternation + r")(?!\w)")
    for doc_id, text in docs:
        for m in pattern.finditer(text.lower()):
            for ent in mention_to_ids[m.group(0)]:
                assoc.add(doc_id, ent)
    return assoc


# ---------------------------------------------------------------------------
# Amazon review JSON (one JSON object per line: asin, reviewText, summary).
# ---------------------------------------------------------------------------

_REVIEW_SUFFIXES = (".json", ".json.gz", ".jsonl", ".jsonl.gz")


def expand_review_paths(paths: Iterable[str]) -> List[str]:
    """Expand directory arguments into their contained review files
    (recursive walk, sorted for a deterministic file index); plain file
    paths pass through in order. Mirrors the TREC side's corpus-tree
    ingestion for the product pipeline: real Amazon dumps ship as one or
    more ``.json.gz`` per category, often nested under a category tree."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            hits = [os.path.join(root, f)
                    for root, _dirs, files in os.walk(p)
                    for f in files if f.endswith(_REVIEW_SUFFIXES)]
            if not hits:
                raise ValueError(
                    f"no review JSON files (*{'/ *'.join(_REVIEW_SUFFIXES)})"
                    f" under directory {p!r}")
            out.extend(sorted(hits))
        else:
            out.append(p)
    return out


def iter_amazon_reviews(paths: Iterable[str]) -> Iterator[Tuple[str, str, str]]:
    """Yield (review_id, asin, text) from Amazon review JSON-lines files
    (or directories of them — ``expand_review_paths``).

    Review ids are ``f{file_index}:{line}``: stable across path spellings
    and CWDs (unlike embedding the path) while still collision-free for
    same-named files in different directories (unlike the basename)."""
    for fi, path in enumerate(expand_review_paths(paths)):
        with _open_maybe_gzip(path) as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                asin = obj.get("asin")
                if not asin:
                    continue
                text = " ".join(
                    str(obj.get(k, "")) for k in ("summary", "reviewText", "description"))
                yield f"f{fi}:{i}", asin, text


def build_product_collection(
    review_paths: Iterable[str],
) -> Tuple[Dict[str, str], Associations, EntityRegistry]:
    """Products are entities; each review document is associated with its
    product (the LSE setting: an entity's text is its own reviews)."""
    registry = EntityRegistry()
    assoc = Associations()
    docs: Dict[str, str] = {}
    for review_id, asin, text in iter_amazon_reviews(review_paths):
        ent = registry.add(asin)
        docs[review_id] = text
        assoc.add(review_id, ent)
    return docs, assoc, registry
