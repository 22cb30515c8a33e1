"""Tokenization and stopwords.

The reference tokenized with nltk and filtered standard English stopwords
(SURVEY.md section 3.1 "Tokenizer + vocabulary"). This implementation is
self-contained (regex word tokenizer + embedded stopword list) so the
framework has no runtime dependency on nltk data files, which are not
downloadable offline.
"""

from __future__ import annotations

import re
from typing import List

# Standard English stopword list (the classic ~127-word set used by
# nltk/sklearn-style pipelines), embedded to stay offline-safe.
STOPWORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves
""".split())

# Case-insensitive: with lowercase=False the original casing is kept, so the
# pattern must match uppercase spans too (a lowercase-only pattern would
# silently truncate 'Hello' to 'ello').
_WORD_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9']*")
_NUM_RE = re.compile(r"^[0-9]+$")


def config_opts(cfg) -> dict:
    """The tokenizer options a DataConfig carries — the ONE mapping shared
    by the serial, multiprocessing, and native-C++ paths (and the native
    counter/vocab constructors), so adding an option cannot silently
    desynchronize the three byte-identical pipelines."""
    return dict(lowercase=cfg.lowercase,
                filter_stopwords=cfg.filter_stopwords,
                min_token_len=cfg.min_token_len,
                drop_numeric=cfg.drop_numeric)


def tokenize_cfg(text: str, cfg) -> List[str]:
    """tokenize() parameterized by a DataConfig."""
    return tokenize(text, **config_opts(cfg))


def tokenize(
    text: str,
    lowercase: bool = True,
    filter_stopwords: bool = True,
    min_token_len: int = 1,
    drop_numeric: bool = False,
) -> List[str]:
    """Split raw text into word tokens.

    Lowercases, extracts alphanumeric word spans (allowing internal
    apostrophes), and optionally drops stopwords / short tokens / pure
    numbers — matching the reference's preprocessing contract.
    """
    if lowercase:
        text = text.lower()
    tokens = _WORD_RE.findall(text)
    out = []
    for t in tokens:
        if len(t) < min_token_len:
            continue
        if filter_stopwords and t in STOPWORDS:
            continue
        if drop_numeric and _NUM_RE.match(t):
            continue
        out.append(t)
    return out
