"""Deterministic synthetic collections with planted term->entity structure.

The reference validated on W3C/CERC (TREC Enterprise) and Amazon review data
(SURVEY.md section 1), none of which can be downloaded offline. This module
generates a stand-in collection where the ranking signal is planted and
known: each entity owns a signature set of terms; its documents mix
signature terms (probability ``signal``) with background Zipf noise. A
correctly trained model must push the planted entity to the top for queries
drawn from its signature, so end-to-end NDCG@100 near 1.0 is achievable and
any large shortfall indicates a real bug (SURVEY.md section 5, test item 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class SyntheticCollection:
    docs: Dict[str, str]                    # doc_id -> raw text
    doc_entities: Dict[str, List[str]]      # doc_id -> entity names
    entities: List[str]                     # all entity names
    topics: Dict[str, str]                  # topic_id -> query text
    qrels: Dict[str, Dict[str, int]]        # topic_id -> {entity: grade}
    vocab_terms: List[str] = field(default_factory=list)


def _term(i: int) -> str:
    return f"term{i:06d}"


def make_synthetic(
    num_entities: int = 64,
    vocab_size: int = 2000,
    docs_per_entity: int = 12,
    doc_len: int = 120,
    signature_size: int = 12,
    signal: float = 0.7,
    num_topics: int = 32,
    query_len: int = 3,
    seed: int = 0,
    hard: bool = False,
    group_size: int = 4,
    doc_skew: float = 0.8,
    vocab_gap: bool = False,
) -> SyntheticCollection:
    """Build a planted-signal collection. Fully deterministic in ``seed``.

    ``hard=False`` (default): disjoint signatures, uniform doc counts, one
    grade-1 relevant entity per topic — a correct model saturates NDCG near
    1.0 (useful as a smoke floor, useless for regression detection once
    saturated — round-1 VERDICT weakness 2).

    ``hard=True`` plants CONFUSABLE structure so trained-model NDCG lands in
    a discriminating band instead of the ceiling:
      * distractor groups: entities come in groups of ``group_size`` whose
        signatures share half their terms (polysemous planted terms); only
        the private half disambiguates, so sloppy models rank siblings up;
      * Zipf association skew: entity i gets ``docs_per_entity`` scaled by
        (rank+1)^-doc_skew (min 1 doc) — tail entities are data-starved;
      * graded qrels: the queried entity is grade 2 and its group siblings
        grade 1 (they genuinely match the query's shared terms), making
        NDCG smooth in ranking quality rather than 0/1;
      * queries mix private and shared signature terms with at least one
        private term, so a perfect model CAN still rank the truth first.
    Sampled-softmax bias, top-k boundary bugs, and under-training all show
    up as visible NDCG drops here (tests/test_quality.py injects a biased
    negative sampler to prove it).

    ``vocab_gap=True`` (requires ``hard=True``) plants a PARAPHRASE
    structure on top of the hard groups — the regime the LSE family exists
    for (SURVEY.md section 1, model family 2: matching query vocabulary to
    entity text across wording), which the plain hard mode structurally
    cannot test because its graded qrels are lexically constructed
    (round-2 VERDICT, missing item 1):

      * every SHARED signature slot becomes a two-form CONCEPT: two
        interchangeable term ids (a "dialect pair"); each group member's
        documents realize each shared concept in ONE form, assigned
        balanced-at-random across the group (both forms of every concept
        are used inside every group);
      * topic queries realize their shared concepts in the form OPPOSITE
        to the target's dialect (plus private terms in the target's own
        vocabulary, which keep the target identifiable);
      * consequence: for each query, the grade-1 siblings whose dialect
        differs from the queried form on every queried concept have ZERO
        occurrences of those query terms — lexically invisible, so a
        term-matching ranker can never pull them above the smoothed
        collection floor — while the two forms of a concept co-predict the
        same entity group during training, so a distributional model
        retrieves the whole group through entity-space geometry. Lexical
        matching is structurally capped; distributional learning is not.

    A correct semantic model therefore BEATS the lexical LM baseline here
    (the CIKM 2016 result shape), instead of losing to it the way any
    model must on the lexically-constructed hard qrels.
    """
    if vocab_gap and not hard:
        raise ValueError("vocab_gap=True requires hard=True (the paraphrase "
                         "structure extends the hard groups)")
    rng = np.random.default_rng(seed)
    terms = [_term(i) for i in range(vocab_size)]

    # Background Zipf distribution over the whole vocabulary.
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    zipf = 1.0 / ranks
    zipf /= zipf.sum()

    # Signatures come from the mid/tail of the vocab (background Zipf noise
    # rarely collides with them). Deal consecutive slices of a shuffled
    # pool: disjoint while the pool lasts, then reshuffle and keep dealing —
    # large collections (entities * signature_size > pool) get overlapping
    # but still entity-identifying signatures.
    sig_pool = rng.permutation(np.arange(vocab_size // 4, vocab_size))
    pos = 0

    def deal(n):
        nonlocal sig_pool, pos
        if pos + n > sig_pool.shape[0]:
            sig_pool = rng.permutation(sig_pool)
            pos = 0
        out = sig_pool[pos:pos + n].copy()
        pos += n
        return out

    signatures = []
    private_masks = []  # hard mode: which signature slots disambiguate
    # vocab_gap bookkeeping (per entity): the two term forms of each shared
    # concept [shared_n, 2] and this entity's dialect per concept [shared_n]
    # (docs realize concept c as forms[c, dialect[c]]).
    shared_forms: List[np.ndarray] = []
    dialects: List[np.ndarray] = []
    if hard:
        shared_n = signature_size // 2
        private_n = signature_size - shared_n
        for gstart in range(0, num_entities, group_size):
            g = min(group_size, num_entities - gstart)
            if vocab_gap:
                forms = deal(2 * shared_n).reshape(shared_n, 2)
                # Balanced dialect assignment per concept: each concept's
                # two forms are BOTH used inside the group (g >= 2), so the
                # query-side anti-dialect form of any member is a trained,
                # in-collection term, never an untrainable orphan.
                dial = np.stack([
                    rng.permutation(np.arange(g) % 2) for _ in range(shared_n)
                ], axis=1)                      # [g, shared_n]
                if g == 1:
                    dial[:] = 0                 # degenerate group: one form
                for m in range(g):
                    shared = forms[np.arange(shared_n), dial[m]]
                    sig = np.concatenate([shared, deal(private_n)])
                    signatures.append(sig)
                    private_masks.append(np.arange(signature_size) >= shared_n)
                    shared_forms.append(forms)
                    dialects.append(dial[m])
            else:
                shared = deal(shared_n)
                for _ in range(g):
                    sig = np.concatenate([shared, deal(private_n)])
                    signatures.append(sig)
                    private_masks.append(
                        np.arange(signature_size) >= shared_n)
    else:
        for _ in range(num_entities):
            signatures.append(deal(signature_size))
            private_masks.append(np.ones(signature_size, bool))

    # Association skew: docs per entity (uniform unless hard).
    if hard:
        w = (np.arange(num_entities, dtype=np.float64) + 1.0) ** (-doc_skew)
        w *= num_entities / w.sum()          # mean 1.0
        n_docs = np.maximum(1, np.round(docs_per_entity * w)).astype(int)
    else:
        n_docs = np.full(num_entities, docs_per_entity, int)

    entities = [f"entity{i:04d}" for i in range(num_entities)]
    docs: Dict[str, str] = {}
    doc_entities: Dict[str, List[str]] = {}
    # One vectorized draw for every token of every ACTUAL document. Two
    # scale traps live here: (1) a dense [E, max_docs, len] buffer sizes by
    # the skew's MAX doc count, not the sum — at 3500 hard-mode entities
    # that is 573M slots for 3.4M real tokens; (2) rng.choice with a
    # 40k-category p is far slower than inverse-CDF sampling. Both made
    # recipe-scale hard collections take an hour to generate.
    sig_matrix = np.stack(signatures)                       # [E, sig]
    total_docs = int(n_docs.sum())
    doc_owner = np.repeat(np.arange(num_entities), n_docs)  # [D]
    starts = np.cumsum(n_docs) - n_docs
    di_within = np.arange(total_docs) - starts[doc_owner]
    shape = (total_docs, doc_len)
    sig_pick = sig_matrix[doc_owner[:, None],
                          rng.integers(0, signature_size, size=shape)]
    zipf_cdf = np.cumsum(zipf)
    noise_pick = np.minimum(
        np.searchsorted(zipf_cdf, rng.random(size=shape), side="right"),
        vocab_size - 1)
    token_ids = np.where(rng.random(shape) < signal, sig_pick, noise_pick)
    for d in range(total_docs):
        ei = int(doc_owner[d])
        doc_id = f"doc-{ei:04d}-{int(di_within[d]):03d}"
        docs[doc_id] = " ".join(terms[t] for t in token_ids[d])
        doc_entities[doc_id] = [entities[ei]]

    # Topics: queries drawn from one entity's signature; that entity is the
    # top answer. Topic entities cycle deterministically. Hard mode: at
    # least one PRIVATE term per query (the truth stays identifiable) and
    # group siblings are graded 1 (they match the shared terms).
    topics: Dict[str, str] = {}
    qrels: Dict[str, Dict[str, int]] = {}
    for ti in range(num_topics):
        ei = ti % num_entities
        if hard:
            priv = signatures[ei][private_masks[ei]]
            n_priv = min(max(1, query_len // 2), len(priv), query_len)
            q_priv = rng.choice(priv, size=n_priv, replace=False)
            n_rest = query_len - n_priv
            if vocab_gap and n_rest > 0:
                # Shared concepts realized in the ANTI-dialect of the
                # target: the query paraphrases the target's wording using
                # the sibling-side form of each concept, so the target (and
                # every same-dialect sibling) has ZERO literal occurrences
                # of these query terms — the planted vocabulary gap.
                forms, dial = shared_forms[ei], dialects[ei]
                shared_n = forms.shape[0]
                n_rest = min(n_rest, shared_n)
                concepts = rng.choice(shared_n, size=n_rest, replace=False)
                # A singleton trailing group has no sibling using the
                # opposite form — fall back to the entity's own dialect so
                # the query never contains an untrained orphan term.
                g0 = (ei // group_size) * group_size
                singleton = min(group_size, num_entities - g0) == 1
                flip = dial[concepts] if singleton else 1 - dial[concepts]
                q_rest = forms[concepts, flip]
            elif n_rest > 0:
                q_rest = rng.choice(signatures[ei], size=n_rest,
                                    replace=False)
            else:
                q_rest = np.empty(0, int)
            q_terms = np.concatenate([q_priv, q_rest.astype(int)])
            g0 = (ei // group_size) * group_size
            group = range(g0, min(g0 + group_size, num_entities))
            qrels_t = {entities[j]: 1 for j in group if j != ei}
            qrels_t[entities[ei]] = 2
        else:
            q_terms = rng.choice(signatures[ei], size=query_len,
                                 replace=False)
            qrels_t = {entities[ei]: 1}
        tid = f"T{ti:03d}"
        topics[tid] = " ".join(terms[t] for t in q_terms)
        qrels[tid] = qrels_t

    return SyntheticCollection(
        docs=docs,
        doc_entities=doc_entities,
        entities=entities,
        topics=topics,
        qrels=qrels,
        vocab_terms=terms,
    )
