"""Plain PyTorch reference of the LSE model's sampled-softmax training.

The model of Van Gysel et al. (CIKM 2016, "Learning Latent Vector Spaces
for Product Search"), as this repository's recipes train it: a window's
word embeddings, mean-pooled over its length, are projected into entity
space by tanh(x W + b); the loss is the softmax over the window's entity
and k candidates shared by the batch, drawn from the unigram noise
q ∝ count^power, each corrected by -log(k q) (the importance-corrected
sampled softmax), with a candidate equal to the row's own entity left
out. Adam updates the params: every row of every table ("dense"), or,
for the embedding tables, only the rows the step gathers ("lazy": the
rows it does not gather keep their values and their moments).

Everything is float32 (TF32 off) but the storage: params and moments are
held in the configuration's parameter dtype, and adam's constants are
applied as optax applies them to leaves of that dtype (rounded to it).
``compute="fp8"`` is the control: the operands that the configuration
multiplies in its compute dtype (the gathered word rows, the pooled rows
and W, the reps and candidates of the sampled logits) are rounded to
float8 e4m3 with a per-tensor scale first.

The tables hold only the rows that the steps touch, with their global
ids: a row no step touches has a zero gradient and zero moments, and
neither dense nor lazy adam moves it. This module imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8     # adam's defaults
SCAN_WIDTH = 1024
FP8_MAX = 448.0                    # float8 e4m3's largest finite value
LEAVES = ("word_emb", "proj_w", "proj_b", "entity_emb")
ROW_LEAVES = ("word_emb", "entity_emb")


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums in a fixed order: rows of 1024 scanned, then
    the scanned row totals added (the noise CDF's rule)."""
    n = x.numel()
    if n <= SCAN_WIDTH:
        return torch.cumsum(x.expand(2, n), dim=1)[0]
    rows = -(-n // SCAN_WIDTH)
    m = torch.nn.functional.pad(x, (0, rows * SCAN_WIDTH - n))
    m = torch.cumsum(m.view(rows, SCAN_WIDTH), dim=1)
    before = torch.nn.functional.pad(_cumsum(m[:, -1])[:-1], (1, 0))
    return (m + before[:, None]).reshape(-1)[:n]


def noise_table(counts: torch.Tensor, power: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cdf, log q) [E] float32 of q = softmax(power * log counts)."""
    z = power * torch.log(counts.float().clamp(min=1e-12))
    return _cumsum(torch.softmax(z, 0)), torch.log_softmax(z, 0)


def draw_negatives(gen: torch.Generator, cdf: torch.Tensor,
                   k: int) -> torch.Tensor:
    """[k] int64 candidates iid from q by inverse CDF, one uniform draw
    of [1, k] from ``gen`` on the CDF's device."""
    u = torch.rand((1, k), generator=gen, device=cdf.device) * cdf[-1]
    return torch.searchsorted(cdf, u)[0].clamp(max=cdf.numel() - 1)


def cosine_lr(count: int, peak: float, horizon: int,
              final_fraction: float) -> float:
    """optax's cosine decay from ``peak`` to ``final_fraction * peak``
    over ``horizon`` updates, at ``count`` completed updates."""
    c = min(count, horizon)
    return peak * ((1.0 - final_fraction) * 0.5
                   * (1.0 + math.cos(math.pi * c / horizon))
                   + final_fraction)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes through unchanged."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    y = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (y - x).detach()


@dataclasses.dataclass
class Steps:
    """What the check compares of a few steps. ``first_grads``: each
    leaf's first gradient as (sorted global ids of its rows, or None for a
    whole leaf; float32 values), holding every row that is not zero."""
    losses: List[float]
    grad_norms: Dict[str, float]       # of the first step's gradient
    first_grads: Dict[str, Tuple[Optional[torch.Tensor], torch.Tensor]]
    change_norms: Dict[str, float]     # of the params' change over all steps
    changed: Dict[str, torch.Tensor]   # row leaves: global ids that moved


def run(start: Dict[str, Tuple[Optional[torch.Tensor], torch.Tensor]],
        batches: List[Dict[str, torch.Tensor]],
        negatives: List[torch.Tensor], logq: torch.Tensor, lrs: List[float],
        lazy: bool, compute: str = "fp32", half_batch: bool = False,
        loss_scale: float = 1.0) -> Steps:
    """Train from ``start`` (leaf -> (sorted global row ids, or None for
    a whole leaf; values in the storage dtype)) over ``batches`` (windows
    [B, w], lengths [B], entities [B]) with the candidates ``negatives``
    and learning rates ``lrs`` of each step.

    ``half_batch`` (a fault) trains each step on the first half of its
    rows; ``loss_scale`` (a fault) scales the loss as it is produced."""
    if compute not in ("fp32", "fp8"):
        raise ValueError(f"compute must be fp32 or fp8, got {compute!r}")
    q = _fp8 if compute == "fp8" else (lambda x: x)
    ids = {leaf: start[leaf][0] for leaf in LEAVES}
    store = {leaf: start[leaf][1].clone() for leaf in LEAVES}
    m = {leaf: torch.zeros_like(store[leaf]) for leaf in LEAVES}
    v = {leaf: torch.zeros_like(store[leaf]) for leaf in LEAVES}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    first: Dict[str, Tuple[Optional[torch.Tensor], torch.Tensor]] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t, (batch, neg) in enumerate(zip(batches, negatives), start=1):
            windows = batch["windows"].long()
            lengths = batch["lengths"].long()
            pos = batch["entities"].long()
            if half_batch:
                half = windows.shape[0] // 2
                windows, lengths, pos = windows[:half], lengths[:half], \
                    pos[:half]
            k = neg.numel()
            lw = torch.searchsorted(ids["word_emb"], windows)
            lp = torch.searchsorted(ids["entity_emb"], pos)
            ln = torch.searchsorted(ids["entity_emb"], neg)
            leaf = {n: store[n].detach().float().requires_grad_(True)
                    for n in LEAVES}

            rows = q(leaf["word_emb"][lw])
            mask = (torch.arange(windows.shape[1], device=windows.device)
                    [None, :] < lengths[:, None]).float()
            pooled = ((rows * mask[:, :, None]).sum(1)
                      / lengths.clamp(min=1).float()[:, None])
            reps = torch.tanh(q(pooled) @ q(leaf["proj_w"]) + leaf["proj_b"])
            s_pos = torch.sum(reps * leaf["entity_emb"][lp], dim=-1)
            corr = logq[neg] + math.log(k)
            s_neg = q(reps) @ q(leaf["entity_emb"][ln]).T - corr[None, :]
            s_neg = s_neg.masked_fill(neg[None, :] == pos[:, None],
                                      float("-inf"))
            lse = torch.logsumexp(torch.cat([s_pos[:, None], s_neg], 1), 1)
            loss = torch.mean(lse - s_pos) * loss_scale
            grads = dict(zip(LEAVES, torch.autograd.grad(
                loss, [leaf[n] for n in LEAVES])))
            losses.append(float(loss.detach()))
            if t == 1:
                grad_norms = {n: float(grads[n].norm()) for n in LEAVES}
                first = {n: (ids[n], grads[n].detach()) for n in LEAVES}
            touched = {"word_emb": lw.reshape(-1),
                       "entity_emb": torch.cat([lp, ln])}
            with torch.no_grad():
                for n in LEAVES:
                    sel = (torch.unique(touched[n])
                           if lazy and n in ROW_LEAVES else None)
                    _adam(store[n], m[n], v[n], grads[n], sel, lrs[t - 1], t)
            del leaf, grads, rows, pooled, reps, s_neg, lse, loss
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    change_norms, changed = {}, {}
    for n in LEAVES:
        delta = store[n].float() - start[n][1].float()
        change_norms[n] = float(delta.norm())
        if n in ROW_LEAVES:
            changed[n] = ids[n][(delta != 0).any(dim=1)]
    return Steps(losses, grad_norms, first, change_norms, changed)


def _adam(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          g: torch.Tensor, sel: Optional[torch.Tensor], lr: float,
          t: int) -> None:
    """Adam at count ``t`` on the rows ``sel`` (all rows where None), in
    place: the moments and the param kept in ``p``'s dtype, the constants
    as that dtype holds them, the arithmetic and bias corrections in
    float32."""
    def c(x: float) -> float:
        return float(torch.tensor(x, dtype=p.dtype))

    if sel is not None:
        pp, mm, vv, g = p[sel], m[sel], v[sel], g[sel]
    else:
        pp, mm, vv = p, m, v
    m_new = (c(B1) * mm.float() + c(1.0 - B1) * g).to(p.dtype)
    v_new = (c(B2) * vv.float() + c(1.0 - B2) * g * g).to(p.dtype)
    m_hat = m_new.float() / (1.0 - B1 ** t)
    v_hat = v_new.float() / (1.0 - B2 ** t)
    p_new = (pp.float() - lr * m_hat / (torch.sqrt(v_hat) + EPS)).to(p.dtype)
    if sel is None:
        p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)
    else:
        p[sel], m[sel], v[sel] = p_new, m_new, v_new
