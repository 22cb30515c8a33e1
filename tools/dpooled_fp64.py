#!/usr/bin/env python3
"""Where the pure-TP fused step's fp32 gap on the word table lies: the first
micro-step's dpooled from one card's K7 and from the mesh's entity blocks,
each against an fp64 dpooled on the card, and the word table's gradient
that each gives through the head's backward.

    python tools/dpooled_fp64.py [--seed 0] [--blocks 4]
        [--dp-max-tiles 32 ...]

At chip_smoke.py's ``mesh_fused_tp`` width (log-linear, E 500k, V 60k, d
256, B 1024, fp32 compute), from the seeded initial state and first batch
that ``parallel.dryrun.check_fused_card_world`` takes for ``--seed``:
- one card: K5 + K7 over every entity (``ops.xent.xent_loss_apply``);
- the mesh: ``--blocks`` entity blocks, each K5, then K7 fed the stitched
  lse and labels of -1 off the block, as ``ops.xent.sharded_xent_apply``
  runs them on a rank; the blocks' dpooled summed in block order here
  (gloo sums the ranks' in its own order);
- fp64: z, p = exp(z - lse) - onehot and p W in fp64 from the same fp32
  operands, in chunks of entities.
The update is sgd at lr 0, so W is left as it is. For each
``--dp-max-tiles`` (``ops.xent.DP_MAX_TILES``, the entity tiles a block of
the dpooled sweep sums on the tensor cores before it adds them into its
partial; the module's own by default; a chunk's length or more sums each
chunk whole) prints, for dpooled and for
the word table's gradient each gives (the head's backward in fp32; the
fp64 one in fp64), ||x - ref|| / ||ref|| and max |x - ref| / max |ref|
against fp64 and between one card and the mesh; then one JSON object as
its last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 50_000          # entities a chunk of the fp64 sums


def _errs(x, ref) -> dict:
    x, ref = x.double(), ref.double()
    return {"rel_norm": ((x - ref).norm() / ref.norm()).item(),
            "max_rel": ((x - ref).abs().max() / ref.abs().max()).item()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/dpooled_fp64.py")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--dp-max-tiles", type=int, nargs="+")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dpooled_fp64: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from sert_tpu_torch.models.common import masked_mean_embed
    from sert_tpu_torch.ops import xent
    from sert_tpu_torch.ops.sampled_lse import _operand
    from sert_tpu_torch.parallel.dryrun import seeded_batches
    from sert_tpu_torch.train.step import init_state
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card(), flush=True)
    mcfg, tcfg, window = chip_smoke._ab_configs()
    mcfg = mcfg.replace(compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, seed=a.seed, optimizer="sgd")
    state = init_state(a.seed, mcfg, tcfg, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             seeded_batches(mcfg, tcfg, window, 1, a.seed)[0].items()}
    words = state.params["word_emb"].detach().requires_grad_(True)
    pooled = masked_mean_embed(words, batch["windows"], batch["lengths"],
                               torch.float32)
    P = pooled.detach()
    W = state.params["proj_w"].detach()
    bias = state.params["proj_b"].detach().float()
    labels = batch["entities"].long()
    B, E = P.shape[0], W.shape[1]
    gscale = 1.0 / B
    kw = dict(opt="sgd", opt_tree={}, lr=0.0, count=0, gscale=gscale,
              layout="de", dtype="float32")
    f32 = torch.float32

    def dpooled():
        """(one card's dpooled, the mesh's, the mesh's stitched lse)."""
        one = xent.xent_loss_apply(P, W.clone(), bias, labels, **kw)[4]
        # The mesh's blocks, as _block_forward and _bwd_apply run them.
        n, El = a.blocks, E // a.blocks
        Wj = [W[:, j * El:(j + 1) * El].contiguous() for j in range(n)]
        bj = [bias[j * El:(j + 1) * El].contiguous() for j in range(n)]
        lses = [xent.xent_lse(P, Wj[j], bj[j], "de", "float32")
                for j in range(n)]
        M = torch.stack(lses).amax(dim=0)
        lse = M + torch.log(sum(torch.exp(x - M) for x in lses))
        mesh = torch.zeros_like(one)
        for j in range(n):
            lab = labels - j * El
            lab_k = torch.where((lab >= 0) & (lab < El), lab,
                                torch.full_like(lab, -1))
            geometry = xent._geometry(P, Wj[j], bj[j], lab_k, "de", f32)
            saved = (_operand(P, f32, geometry[3]), Wj[j].clone(), bj[j],
                     lab_k.to(torch.int32).contiguous(), lse.contiguous(),
                     None)
            mesh += xent._bwd_apply(saved, geometry, [], "sgd", 0.0, 0,
                                    gscale, f32)[1]
        return one, mesh, lse

    with torch.no_grad():
        # fp64 from the same fp32 operands, in chunks of entities.
        P64, b64 = P.double(), bias.double()
        chunks = [(c, min(c + CHUNK, E)) for c in range(0, E, CHUNK)]
        lse64 = torch.logsumexp(torch.stack([
            torch.logsumexp(P64 @ W[:, c0:c1].double() + b64[c0:c1], dim=1)
            for c0, c1 in chunks]), dim=0)
        ref = torch.zeros_like(P64)
        rows = torch.arange(B, device=P.device)
        for c0, c1 in chunks:
            Wc = W[:, c0:c1].double()
            p = torch.exp(P64 @ Wc + b64[c0:c1] - lse64[:, None])
            own = (labels >= c0) & (labels < c1)
            p[rows[own], labels[own] - c0] -= 1.0
            ref += p @ Wc.T
        ref *= gscale

    def word_grad(dp):
        return torch.autograd.grad(pooled, words, grad_outputs=dp.float(),
                                   retain_graph=True)[0]

    words64 = words.detach().double().requires_grad_(True)
    pooled64 = masked_mean_embed(words64, batch["windows"], batch["lengths"])
    ref_words = torch.autograd.grad(pooled64, words64, grad_outputs=ref)[0]
    out = {}
    for cap in a.dp_max_tiles or [xent.DP_MAX_TILES]:
        xent.DP_MAX_TILES = cap
        with torch.no_grad():
            one, mesh, lse = dpooled()
        got = {
            "dp_chunks": {"one_card": xent._dp_chunks(B, E),
                          "block": xent._dp_chunks(B, E // a.blocks)},
            "dpooled": {"one_card_vs_fp64": _errs(one, ref),
                        "mesh_vs_fp64": _errs(mesh, ref),
                        "one_card_vs_mesh": _errs(one, mesh),
                        "lse_one_card_vs_fp64": _errs(
                            xent.xent_lse(P, W, bias, "de", "float32"),
                            lse64),
                        "lse_mesh_vs_fp64": _errs(lse, lse64)},
            "word_grad": {"one_card_vs_fp64": _errs(word_grad(one),
                                                    ref_words),
                          "mesh_vs_fp64": _errs(word_grad(mesh), ref_words),
                          "one_card_vs_mesh": _errs(word_grad(one),
                                                    word_grad(mesh)),
                          "fp32_head_of_fp64_vs_fp64": _errs(word_grad(ref),
                                                             ref_words)}}
        print(f"dp_max_tiles={cap} dp_chunks={got['dp_chunks']}", flush=True)
        for what in ("dpooled", "word_grad"):
            for name, e in got[what].items():
                print(f"dp_max_tiles={cap} {what} {name} "
                      f"rel_norm={e['rel_norm']:.3e} "
                      f"max_rel={e['max_rel']:.3e}", flush=True)
        out[str(cap)] = got
    print(json.dumps({"seed": a.seed, "blocks": a.blocks, "B": B, "E": E,
                      "d": P.shape[1], "compute": "float32",
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": chip_smoke.card(),
                      "by_dp_max_tiles": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
