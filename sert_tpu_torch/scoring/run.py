"""Topics -> TREC run glue (port of ``sert_tpu/scoring/run.py``): batch
queries, score them against every entity, keep the top k per topic.

Queries pad to a fixed term budget; topics whose terms are all out of
vocabulary yield empty result lists.
"""

from __future__ import annotations

from typing import (Any, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from sert_tpu_torch.models.api import entity_matrix
from sert_tpu_torch.ops.exact_topk import (prepare_entities,
                                           resolve_rescore_dtype)
from sert_tpu_torch.ops.score_binmax import kernel_limits as binmax_limits
from sert_tpu_torch.scoring.scorer import (_entity_matrix, dense_scores,
                                           pallas_topk, streaming_topk)
from sert_tpu_torch.utils.config import ModelConfig, ScoreConfig


def resolve_engine(sc: ScoreConfig, num_entities: int,
                   device: torch.device, dim: int) -> str:
    """The scoring engine for params on ``device`` whose entity matrix is
    ``dim`` wide. "pallas" is the K3 + K4 kernel engine (the recipes' name
    for it); "distributed" the entity-sharded engine over the score mesh
    (``parallel/topk.py``). "auto": the kernel engine on a CUDA device
    where K3 takes the padded width (``ops.score_binmax.kernel_limits``);
    otherwise, on either device, dense scoring up to ``entity_chunk``
    entities and the exact streaming scan above (the reference's rule off
    the TPU). ``use_pallas`` is the legacy alias."""
    if sc.use_pallas:
        return "pallas"
    if sc.engine != "auto":
        if sc.engine not in ("dense", "streaming", "pallas", "approx",
                             "distributed"):
            raise ValueError(f"unknown scoring engine {sc.engine!r}")
        return sc.engine
    if device.type == "cuda" and binmax_limits(dim) is None:
        return "pallas"
    return "dense" if num_entities <= sc.entity_chunk else "streaming"


def stage_entities(params, cfg: ModelConfig, sc: ScoreConfig):
    """The kernel engine's one-time staging of the entity matrix
    (ops.exact_topk.prepare_entities) in the rescore dtype ``sc`` resolves
    for it."""
    M = _entity_matrix(params, cfg, sc.similarity)
    rdt = resolve_rescore_dtype(sc.rescore_dtype, *M.shape)
    return prepare_entities(M, rescore_dtype=rdt, layout=sc.layout)


class DistStaged(NamedTuple):
    """The distributed engine's one-time staging: the score mesh, this
    rank's params (its entity block; the rest replicated), the per-shard
    K3/K4 staging where the local engine is "pallas", and the resolved
    local engine. Pass it as ``score_topics(..., prep=...)``."""
    mesh: Any
    params: Any
    prep: Any
    local_engine: str


def stage_distributed(params, cfg: ModelConfig, sc: ScoreConfig
                      ) -> DistStaged:
    """The score mesh (``sc.mesh_shape``, (1, -1): every rank on
    ``model``) over the world of ranks, with this rank's block of the
    params on the params' device and, for "pallas", its block staged once
    for K3/K4. At one rank the block is the params themselves (no copy)."""
    from sert_tpu_torch.parallel.mesh import make_mesh
    from sert_tpu_torch.parallel.topk import (local_params,
                                              prepare_distributed,
                                              resolve_local_engine)
    device = params["word_emb"].device
    mesh = make_mesh(tuple(sc.mesh_shape), device=device)
    params = local_params(params, cfg, mesh)
    M = entity_matrix(params, cfg)
    local_engine = resolve_local_engine(sc.local_engine, device, M.shape[1])
    prep = None
    if local_engine == "pallas":
        prep = prepare_distributed(
            params, cfg, mesh, similarity=sc.similarity,
            rescore_dtype=resolve_rescore_dtype(sc.rescore_dtype,
                                                *M.shape))
    return DistStaged(mesh, params, prep, local_engine)


# The engine's query-term budget; longer queries truncate.
MAX_QUERY_TERMS = 16


def pad_queries(encoded: Mapping[str, Sequence[int]],
                max_terms: int = MAX_QUERY_TERMS,
                ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(qids, term_ids [Q, T], num_terms [Q]); long queries truncate to T."""
    qids = sorted(encoded)
    Q = len(qids)
    term_ids = np.zeros((Q, max_terms), np.int32)
    num_terms = np.zeros((Q,), np.int32)
    for i, qid in enumerate(qids):
        ids = list(encoded[qid])[:max_terms]
        term_ids[i, :len(ids)] = ids
        num_terms[i] = len(ids)
    return qids, term_ids, num_terms


def score_topics(
    params,
    cfg: ModelConfig,
    encoded_topics: Mapping[str, Sequence[int]],
    entity_names: Sequence[str],
    score_cfg: Optional[ScoreConfig] = None,
    max_terms: int = MAX_QUERY_TERMS,
    prep=None,
) -> Dict[str, List[Tuple[str, float]]]:
    """Score every topic against every entity; returns a TREC run dict
    {qid: [(entity_name, score), ...]} with the top k per topic.

    Runs on the params' device. ``prep``: the engine's one-time staging,
    for repeated calls: ops.exact_topk.prepare_entities for the kernel
    engine, :func:`stage_distributed`'s result for the distributed one
    (whose every rank calls this with the same topics); without it each
    call stages the entity matrix again."""
    sc = score_cfg or ScoreConfig()
    qids, term_ids, num_terms = pad_queries(encoded_topics, max_terms)
    E = len(entity_names)
    run: Dict[str, List[Tuple[str, float]]] = {qid: [] for qid in qids}
    device = params["word_emb"].device

    engine = resolve_engine(sc, E, device,
                            entity_matrix(params, cfg).shape[1])
    if engine == "pallas" and prep is None:
        prep = stage_entities(params, cfg, sc)
    elif engine == "distributed":
        staged = (prep if isinstance(prep, DistStaged)
                  else stage_distributed(params, cfg, sc))
    if engine == "approx" and not 0.0 < sc.recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got "
                         f"{sc.recall_target}")

    B = sc.query_batch
    k = min(sc.top_k, E)

    def dispatch(t, m):
        """Queue one device batch without a host sync: every batch is
        enqueued back to back and read back below."""
        t = torch.from_numpy(t).to(device)
        m = torch.from_numpy(m).to(device)
        if engine == "pallas":
            return pallas_topk(params, cfg, t, m, k=k,
                               similarity=sc.similarity, prep=prep,
                               normalize=sc.normalize_scores,
                               adaptive_bins=sc.adaptive_bins)
        if engine == "distributed":
            from sert_tpu_torch.parallel.topk import distributed_topk
            return distributed_topk(staged.params, cfg, t, m, staged.mesh,
                                    k=k, chunk=min(sc.entity_chunk, E),
                                    similarity=sc.similarity,
                                    merge=sc.merge,
                                    local_engine=staged.local_engine,
                                    prep=staged.prep)
        if engine == "streaming":
            return streaming_topk(params, cfg, t, m, k=k,
                                  chunk=sc.entity_chunk,
                                  similarity=sc.similarity)
        # "approx": the dense scores' exact top k, which is what
        # lax.approx_max_k returns off the TPU at any recall_target.
        scores = dense_scores(params, cfg, t, m, similarity=sc.similarity)
        return torch.topk(scores, k, dim=1)

    pending = []
    with torch.no_grad():
        for lo in range(0, len(qids), B):
            hi = min(lo + B, len(qids))
            n = hi - lo
            # Pad the last batch to the fixed batch size.
            t = np.zeros((B, max_terms), np.int32)
            m = np.zeros((B,), np.int32)
            t[:n], m[:n] = term_ids[lo:hi], num_terms[lo:hi]
            pending.append((lo, n, m, dispatch(t, m)))

    for lo, n, m, (top_s, idx) in pending:
        top_s, idx = top_s.cpu().numpy(), idx.cpu().numpy()   # sync point
        for qi in range(n):
            if m[qi] == 0:
                continue  # all-OOV query: no meaningful scores
            order = np.argsort(-top_s[qi], kind="stable")
            run[qids[lo + qi]] = [(entity_names[idx[qi, j]],
                                   float(top_s[qi, j])) for j in order]
    return run
