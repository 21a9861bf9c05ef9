"""The plain references held to the port's plain PyTorch path at small
sizes (the references import nothing of the port; these tests do)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench_small_cells import LM

from harness import common
from reference import precision as P
from reference import qwen2 as RQ
from reference.rounds import grouped_round

SEED = 2 ** 32 + 3
LM32 = dict(LM, compute_dtype="float32")
QWEN2 = common.family(LM32)


def _batch(pool, i):
    return {k: torch.from_numpy(v) for k, v in pool[i].items()}


def test_qwen2_forward_matches_port():
    from repro_torch.models import transformer as M
    arch = QWEN2.program_config(LM32)
    params = QWEN2.params(LM32, SEED, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        LM["vocab_size"], size=(2, 12)).astype(np.int64))
    want, _, _ = M.forward(params, {"tokens": toks}, arch)
    got = RQ.forward(params, toks, LM32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    seq = RQ.sequence_logits(params, [toks[0], toks[1, :7]], LM32)["fp32"]
    torch.testing.assert_close(seq[0], want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(seq[1], want[1, :7], rtol=1e-4, atol=1e-4)
    loss = RQ.train_loss(params, {"tokens": toks, "labels": toks}, LM32)
    want_loss = M.lm_loss(params, {"tokens": toks, "labels": toks}, arch)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)


def test_grouped_round_matches_engine():
    """Two rounds of the engine's closed form against the reference's
    sub-steps one by one."""
    from repro_torch.engine import Engine
    mix = {"generator": "token_pool", "batch": 8, "seq": 6, "pool": 2}
    pool = common.generator(mix)(mix, LM32, SEED, 0.0, "cpu")
    loss_fn, head, params = QWEN2.train_program(LM32, {}, SEED, "cpu")
    mom = P_zeros(params)
    eng = Engine(loss_fn, strategy="grouped-fused", num_groups=4, lr=0.05,
                 momentum=0.3, head_filter=head, update_impl="torch",
                 device="cpu")
    p, v, losses = eng.run(params, mom, pool, steps=2)
    w, m = QWEN2.params(LM32, SEED, "cpu"), P_zeros(params)
    for i in range(2):
        w, m, loss, _ = grouped_round(
            w, m, _batch(pool, i), lambda q, b: RQ.train_loss(q, b, LM32),
            groups=4, lr=0.05, momentum=0.3, is_head=RQ.is_head)
        assert loss == pytest.approx(float(losses[i]), rel=1e-5)
    from harness.weights import leaves_with_paths
    for (path, a), (_, b) in zip(leaves_with_paths(p), leaves_with_paths(w)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6,
                                   msg=lambda s: f"{path}: {s}")


def P_zeros(tree):
    if isinstance(tree, dict):
        return {k: P_zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(P_zeros(v) for v in tree)
    return torch.zeros_like(tree)


def test_lower_precisions_round_as_stated():
    x = torch.randn(1000, dtype=torch.float32)
    t = P.round_tf32(x)
    bits = t.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0
    assert float(((t - x) / x).abs().max()) <= 2 ** -11
    q = P.round_fp8(x)
    assert float((q - x).abs().max()) <= float(x.abs().max()) * 2 ** -4
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    torch.testing.assert_close(P.matmul(a, b, "fp32"), a @ b)
    err = (P.matmul(a, b, "fp8") - a @ b).abs().max()
    assert 0 < float(err) < 1.0
    a.requires_grad_(True)
    P.matmul(a, b, "fp8").sum().backward()
    assert a.grad is not None


def test_sequence_logits_low_precision_differs():
    params = QWEN2.params(LM, SEED, "cpu")
    toks = torch.arange(10) % LM["vocab_size"]
    out = RQ.sequence_logits(params, [toks], LM, modes=("fp32", "fp8"))
    gap = (out["fp32"][0] - out["fp8"][0]).abs().max()
    assert float(gap) > 0
