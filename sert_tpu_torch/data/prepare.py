"""The 'prepare' step: collection -> vocabulary + instance shards.

Mirrors SURVEY.md section 4.1 end to end: parse, tokenize (pass 1: counts;
pass 2: encode), associate, window, serialize. Works from any in-memory or
streaming (doc_id, text) source, so the synthetic generator and the real
corpus parsers share one path.
"""

from __future__ import annotations

import os
from typing import Dict

from sert_tpu_torch.data.assoc import Associations, EntityRegistry
from sert_tpu_torch.data.instances import InstanceWriter
from sert_tpu_torch.data.lm_stats import LM_STATS_NAME, LMStatsBuilder
from sert_tpu_torch.data.tokenize import config_opts, tokenize_cfg
from sert_tpu_torch.data.vocab import Vocabulary
from sert_tpu_torch.data.windows import extract_windows
from sert_tpu_torch.utils.config import DataConfig
from sert_tpu_torch.utils.logging import get_logger

log = get_logger("prepare")

VOCAB_NAME = "vocab.json"
ENTITIES_NAME = "entities.json"
ASSOC_NAME = "assoc.json"


_tok = tokenize_cfg   # shared option plumbing: data.tokenize.config_opts


def prepare(
    docs: Dict[str, str],
    assoc: Associations,
    registry: EntityRegistry,
    out_dir: str,
    cfg: DataConfig,
    use_native: bool = True,
) -> Dict:
    """Run the full prepare pipeline; returns the instance meta dict.

    ``use_native`` routes the hot window sweep through the C++ feeder when
    the extension is built (sert_tpu_torch/native), with identical output.
    """
    os.makedirs(out_dir, exist_ok=True)

    native = None
    if use_native:
        from sert_tpu_torch.native import loader as native_loader
        native = native_loader.maybe_load()
    native_text = native if (native is not None
                             and getattr(native, "has_text", False)) else None

    log.info("prepare: pass 1 (vocabulary) over %d docs (workers=%d, "
             "native_text=%s)", len(docs), cfg.num_workers,
             native_text is not None)
    tok_opts = config_opts(cfg)
    if cfg.num_workers > 0:
        from sert_tpu_torch.data.parallel_prepare import parallel_term_counts
        counts = parallel_term_counts(list(docs.values()), cfg,
                                      cfg.num_workers)
        vocab = Vocabulary.from_counter(counts, max_size=cfg.vocab_max_size,
                                        min_count=cfg.vocab_min_count)
    elif native_text is not None:
        from collections import Counter
        counter = native_text.make_counter(**tok_opts)
        for text in docs.values():
            counter.add(text)
        vocab = Vocabulary.from_counter(Counter(counter.counts()),
                                        max_size=cfg.vocab_max_size,
                                        min_count=cfg.vocab_min_count)
    else:
        vocab = Vocabulary.build(
            (_tok(text, cfg) for text in docs.values()),
            max_size=cfg.vocab_max_size,
            min_count=cfg.vocab_min_count,
        )
    vocab.save(os.path.join(out_dir, VOCAB_NAME))
    registry.save(os.path.join(out_dir, ENTITIES_NAME))
    assoc.save(os.path.join(out_dir, ASSOC_NAME))

    log.info("prepare: pass 2 (windows) vocab=%d entities=%d", len(vocab), len(registry))
    lm_builder = (LMStatsBuilder(len(vocab))
                  if cfg.build_lm_stats and len(vocab) else None)
    writer = InstanceWriter(
        out_dir,
        window_size=cfg.window_size,
        instances_per_shard=cfg.instances_per_shard,
        seed=cfg.seed,
    )
    def encoded_docs():
        """(doc_id, entity_ids, token_ids) for docs with associations, in
        deterministic corpus order; tokenization runs in C++ when the native
        lib is built, else optionally fans out over a process pool. The LM
        statistics accumulate on this same stream (one corpus pass)."""
        items = [(doc_id, text) for doc_id, text in docs.items()
                 if assoc.entities_for(doc_id)]
        if cfg.num_workers > 0:
            from sert_tpu_torch.data.parallel_prepare import parallel_encode
            stream = ((doc_id, assoc.entities_for(doc_id), token_ids)
                      for doc_id, token_ids in parallel_encode(
                          items, cfg, vocab.term_to_id, cfg.num_workers))
        elif native_text is not None:
            nv = native_text.make_vocab(list(vocab.iter_terms()), **tok_opts)
            # Keep nv.encode's int32 ndarray as-is: a .tolist() here boxed
            # every id into a Python int only for the consumer to re-parse
            # it with np.asarray — O(tokens) waste per doc on exactly the
            # path the C++ tier accelerates.
            stream = ((doc_id, assoc.entities_for(doc_id), nv.encode(text))
                      for doc_id, text in items)
        else:
            stream = ((doc_id, assoc.entities_for(doc_id),
                       vocab.encode(_tok(text, cfg)))
                      for doc_id, text in items)
        for doc_id, ents, token_ids in stream:
            if lm_builder is not None:
                lm_builder.add(ents, token_ids)
            yield doc_id, ents, token_ids

    n_docs_used = 0
    if native is not None:
        # Batched native sweep: encode documents into one concatenated
        # buffer per BATCH_DOCS docs, then one C++ call per batch.
        import numpy as np
        BATCH_DOCS = 512
        buf_tok, buf_ent, doc_off, ent_off = [], [], [0], [0]

        def flush():
            nonlocal buf_tok, buf_ent, doc_off, ent_off
            if len(doc_off) <= 1:
                return
            w, l, e = native.extract_windows_batch(
                np.concatenate(buf_tok) if buf_tok else np.zeros(0, np.int32),
                np.asarray(doc_off, np.int64),
                np.concatenate(buf_ent) if buf_ent else np.zeros(0, np.int32),
                np.asarray(ent_off, np.int64),
                cfg.window_size, cfg.stride)
            if w.shape[0]:
                writer.add(w, l, e)
            buf_tok, buf_ent, doc_off, ent_off = [], [], [0], [0]

        for doc_id, ents, token_ids in encoded_docs():
            if len(token_ids) == 0:   # len(), not truthiness: ndarray or list
                continue
            buf_tok.append(np.asarray(token_ids, np.int32))
            buf_ent.append(np.asarray(ents, np.int32))
            doc_off.append(doc_off[-1] + len(token_ids))
            ent_off.append(ent_off[-1] + len(ents))
            n_docs_used += 1
            if len(doc_off) > BATCH_DOCS:
                flush()
        flush()
    else:
        for doc_id, ents, token_ids in encoded_docs():
            w, l, e = extract_windows(token_ids, ents, cfg.window_size,
                                      cfg.stride)
            if w.shape[0]:
                writer.add(w, l, e)
                n_docs_used += 1

    if lm_builder is not None:
        stats = lm_builder.finalize(len(registry))
        stats.save(os.path.join(out_dir, LM_STATS_NAME))
        log.info("prepare: lm stats nnz=%d total_tokens=%d",
                 len(stats.counts), stats.total_tokens)

    meta = writer.finalize(extra_meta={
        "vocab_size": len(vocab),
        "num_entities": len(registry),
        "vocab_hash": vocab.content_hash(),
        "docs_used": n_docs_used,
    })
    log.info("prepare: wrote %d instances in %d shards",
             meta["num_instances"], len(meta["shards"]))
    return meta


def encode_queries(
    topics: Dict[str, str],
    vocab: Vocabulary,
    cfg: DataConfig,
) -> Dict[str, list]:
    """Tokenize + encode topics with the SAME preprocessing as documents
    (OOV query terms are dropped, reference semantics)."""
    return {tid: vocab.encode(_tok(text, cfg)) for tid, text in topics.items()}
