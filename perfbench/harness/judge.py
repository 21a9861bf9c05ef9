"""How ``correct`` is decided: the plain reference's readings beside the
program's, reduced to the numbers the cell's limits hold.

Training: the reference follows the set-up's first rounds on the same
weights and batches. Compared, each against its limit:

- ``loss_gap``: the largest relative gap of a round's loss;
- ``grad1_gap``: the first gradient as the optimizer gets it, read from
  the momentum after round one: the worst leaf's gap between the
  program's norm and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same of the parameters' change over the rounds.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the last two.

Serving: ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at that position, over a
seeded sample of the finished requests that holds the longest one.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from harness import common
from harness.common import rng

NOUGHT = 1e-3            # of the median leaf's gradient norm
CHECK_TAG = 301


def _tensor_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_reference(cell, seed: int, pool: List[Dict], steps: int, device,
                    mode: str = "fp32", batch_fraction: float = 1.0,
                    own_group: int = -1) -> Dict:
    """The reference's ``steps`` rounds from the benchmark's weights (made
    again from the seed) on pool batches 0..steps-1."""
    from reference.rounds import flatten, grouped_round
    config, s = cell.config, cell.settings
    ref = common.reference(config)
    w = common.family(config).params(config, seed, device)
    loss = lambda p, b: ref.train_loss(p, b, config, mode)
    head = ref.is_head
    w0 = {".".join(map(str, p)): t.detach().float().clone()
          for p, t in flatten(w)}
    mom = _zeros_like(w)
    losses, grad1, gnorm = [], None, None
    for i in range(steps):
        w, mom, value, gn = grouped_round(
            w, mom, _tensor_batch(pool[i], device), loss,
            groups=int(s["groups"]), lr=float(s["lr"]),
            momentum=float(s["momentum"]), is_head=head,
            batch_fraction=batch_fraction, own_group=own_group)
        losses.append(value)
        if i == 0:
            grad1 = {".".join(map(str, p)): float(torch.linalg.vector_norm(
                t, dtype=torch.float64)) for p, t in flatten(mom)}
            gnorm = {".".join(map(str, p)): x for p, x in gn.items()}
    change = {}
    for p, t in flatten(w):
        k = ".".join(map(str, p))
        change[k] = float(torch.linalg.vector_norm(t - w0[k],
                                                   dtype=torch.float64))
    return {"losses": losses, "grad1": grad1, "change": change,
            "gnorm": gnorm}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree, dtype=torch.float32)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the leaf's reference norm and the median kept leaf's."""
    names = [k for k in ref if k in keep]
    if not names:
        return 0.0
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def train_numbers(out: Dict, ref: Dict) -> Dict[str, float]:
    gmed = float(np.median(list(ref["gnorm"].values())))
    keep = {k for k, x in ref["gnorm"].items() if x >= NOUGHT * gmed}
    lp, lr_ = np.asarray(out["losses"]), np.asarray(ref["losses"])
    n = min(len(lp), len(lr_))
    loss_gap = float(np.max(np.abs(lp[:n] - lr_[:n])
                            / np.maximum(np.abs(lr_[:n]), 1e-30)))
    return {"loss_gap": loss_gap,
            "grad1_gap": leaf_gap(out["grad1"], ref["grad1"], keep),
            "change_gap": leaf_gap(out["change"], ref["change"], keep)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def check_sample(requests, finished: Dict[int, np.ndarray], seed: int,
                 k: int) -> List[int]:
    """``k`` finished requests drawn from the seed, the longest (prompt
    and generation) always among them."""
    done = [r for r in requests if r.rid in finished]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.gen, r.rid)).rid
    others = [r.rid for r in done if r.rid != longest]
    pick = list(rng(seed, CHECK_TAG).choice(
        others, size=min(k - 1, len(others)), replace=False)) if others else []
    return [longest] + [int(x) for x in pick]


def served_logit_gap(params, config: Dict, requests, served: Dict[int,
                     np.ndarray], rids: List[int], device,
                     modes=("fp32",)) -> Dict[str, float]:
    """Per precision mode: over the sampled requests, the widest gap by
    which the token served at a position (``"fp32"``: the program's) or
    the token that mode puts first (the lower precisions: the control)
    lies below the float32 reference's best logit there."""
    sequence_logits = common.reference(config).sequence_logits
    by_rid = {r.rid: r for r in requests}
    seqs, spans = [], []
    for rid in rids:
        r = by_rid[rid]
        toks = np.asarray(served[rid], np.int64)
        full = np.concatenate([r.prompt.astype(np.int64), toks[:-1]])
        seqs.append(torch.from_numpy(full).to(device))
        spans.append((len(r.prompt) - 1, toks))
    all_modes = ("fp32",) + tuple(m for m in modes if m != "fp32")
    logits = sequence_logits(params, seqs, config, modes=all_modes)
    out = {}
    for mode in all_modes:
        worst = 0.0
        for i, (start, toks) in enumerate(spans):
            ref = logits["fp32"][i][start:start + len(toks)]
            if mode == "fp32":
                pick = torch.from_numpy(toks).to(device)
            else:
                pick = logits[mode][i][start:start + len(toks)].argmax(-1)
            best = ref.max(-1).values
            got = ref.gather(-1, pick[:, None].long())[:, 0]
            worst = max(worst, float((best - got).max()))
        out[mode] = worst
    return out
