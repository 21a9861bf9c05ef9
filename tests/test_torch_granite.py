"""Granite 4.0-H (the port's hybrid_moe) against the benchmark's plain
float32 reference (``perfbench/reference/granitemoehybrid.py``), on seeded
fp32 weights at small widths on the CPU.

Each contract is checked sound and with a fault planted where it would
break it, and the fault has to show:

- the full forward (Mamba-2, NoPE attention, dropless MoE, the scalings)
  equals the reference's logits;
- ``ContinuousServer`` (plain attention, parallel prefill, ragged prompts,
  more requests than slots) serves at every position the token whose
  reference logit is the best;
- a right-padded prompt leaves the state its unpadded self leaves (a
  fault: ``dt`` not zeroed at the padding);
- a reused slot starts from zero (a fault: the state left unreset);
- when every token's router prefers one expert, nothing is dropped (a
  fault: one choice a token dropped);
- mamba2-2.7b, whose gated norm is off, is the reference's Mamba-2 mixer
  without the norm.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousServer, Request

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from families import granitemoehybrid as FAM  # noqa: E402
from reference import granitemoehybrid as REF  # noqa: E402

SEED = 2 ** 31 + 5
TOL = dict(atol=2e-6, rtol=1e-5)
FULL = json.loads((BENCH / "configs" / "granite-4.0-h-small-20l.json")
                  .read_text())
# the published configuration at small widths: 6 layers, one attention
# (layer 5, as published), chunks of 8
SMALL = dict(FULL, name="small-granite", hidden_size=64,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=32, shared_intermediate_size=48,
             num_local_experts=8, num_experts_per_tok=3, mamba_n_heads=8,
             mamba_d_head=16, mamba_d_state=8, mamba_chunk_size=8,
             vocab_size=256, num_hidden_layers=6, attention_multiplier=1 / 16,
             param_dtype="float32", compute_dtype="float32")
CFG = FAM.program_config(SMALL)


@pytest.fixture(scope="module")
def params():
    return FAM.params(SMALL, SEED, "cpu")


def _tokens(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        SMALL["vocab_size"], size=shape))


def test_program_config_is_the_published_pattern():
    cfg = FAM.program_config(FULL)
    assert cfg.layer_kinds.count("mamba") == 18
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == "attention"] \
        == [5, 15]
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.shared_d_ff) == \
        (72, 10, 1536)
    assert cfg.rope_theta == 0.0 and cfg.ssm_gated_norm


@pytest.mark.parametrize("shape", [(2, 16), (1, 24)])
def test_forward_matches_the_reference(params, shape):
    toks = _tokens(shape)
    want = REF.forward(params, toks, SMALL)
    got, _, _ = T.forward(params, {"tokens": toks}, CFG)
    torch.testing.assert_close(got, want, **TOL)
    seq = REF.sequence_logits(params, [toks[0], toks[0, :5]], SMALL)["fp32"]
    torch.testing.assert_close(seq[1], want[0, :5], **TOL)


def _requests(n=7, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=0.02 * i, prompt=rng.integers(
        SMALL["vocab_size"], size=int(rng.integers(1, 21))).astype(np.int32),
        gen=int(rng.integers(2, 9))) for i in range(n)]


def _worst_gap(params, reqs, tokens):
    """The widest gap between a served token's reference logit and the
    reference's best at its position, over every request."""
    seqs = [torch.from_numpy(np.concatenate([r.prompt, tokens[r.rid][:-1]])
                             .astype(np.int64)) for r in reqs]
    logits = REF.sequence_logits(params, seqs, SMALL)["fp32"]
    worst = 0.0
    for r, lg in zip(reqs, logits):
        ref = lg[len(r.prompt) - 1:]
        got = ref.gather(-1, torch.from_numpy(tokens[r.rid]).long()[:, None])
        worst = max(worst, float((ref.max(-1).values - got[:, 0]).max()))
    return worst


@pytest.mark.parametrize("stale", [False, True], ids=["sound", "unreset"])
def test_server_serves_the_reference_tokens(params, monkeypatch, stale):
    """Three slots, seven ragged requests: slots are reused. Sound, every
    served token is the reference's best; with the state left unreset on
    admission, a reused slot's prompt runs on from its last request's
    state, and the served tokens leave the reference's best."""
    if stale:
        monkeypatch.setattr(ContinuousServer, "_reset_state",
                            lambda self, slots, rids: None)
    srv = ContinuousServer(CFG, params, slots=3, page_size=4, max_seq=64,
                           attn_impl="torch", prefill_mode="parallel",
                           device="cpu")
    reqs = _requests()
    srv.warmup(sorted({len(r.prompt) for r in reqs}))
    rep = srv.run(reqs)
    assert sorted(rep.tokens) == [r.rid for r in reqs]
    assert all(len(rep.tokens[r.rid]) == r.gen for r in reqs)
    gap = _worst_gap(params, reqs, rep.tokens)
    assert (gap > 1e-3) if stale else (gap <= 1e-5), gap
    if not stale:
        share = srv.registry.gauge("serving.moe_live_share").value
        hits = srv.registry.series("serving.moe_expert_hits").values
        assert 0 < share <= 1 and len(hits) == SMALL["num_local_experts"]
        assert sum(hits) > 0


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "dt-kept"])
def test_padded_prompt_leaves_the_unpadded_state(params, monkeypatch, fault):
    """A prompt of 5 tokens right-padded to 16 beside a full row: its SSM
    state and conv tail are those of the 5 tokens alone. Planted: ``dt``
    kept at the padding, which moves the state on."""
    if fault:
        seq = S._ssm_seq
        monkeypatch.setattr(S, "_ssm_seq", lambda p, u, cfg, h0=None,
                            conv0=None, valid=None: seq(p, u, cfg, h0, conv0))
    toks = _tokens((2, 16), seed=4)
    valid = torch.ones(2, 16, dtype=torch.bool)
    valid[1, 5:] = False
    _, _, padded = T.forward(params, {"tokens": toks, "valid": valid}, CFG,
                             return_cache=True)
    _, _, alone = T.forward(params, {"tokens": toks[1:, :5]}, CFG,
                            return_cache=True)
    diff = max(float((padded["ssm"][k][:, 1] - alone["ssm"][k][:, 0])
                     .abs().max()) for k in ("h", "conv"))
    assert (diff > 1e-3) if fault else (diff <= 1e-5), diff
    # the conv tail is the last 3 inputs of the 5-token row
    assert padded["ssm"]["conv"].shape[2] == 3


@pytest.mark.parametrize("stale", [False, True], ids=["sound", "unreset"])
def test_reused_slot_starts_from_zero(params, monkeypatch, stale):
    """One slot, two requests in turn: the second's state after its
    prefill is that of its prompt from zero. Planted: the reset left out,
    so the first request's state is carried in."""
    if stale:
        monkeypatch.setattr(ContinuousServer, "_reset_state",
                            lambda self, slots, rids: None)
    srv = ContinuousServer(CFG, params, slots=1, page_size=4, max_seq=64,
                           attn_impl="torch", prefill_mode="parallel",
                           device="cpu")
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, arrival=0.0, gen=3, prompt=rng.integers(
        SMALL["vocab_size"], size=6).astype(np.int32)) for i in range(2)]
    seen = []
    prefill = srv._prefill

    def record(*args, **kw):
        out = prefill(*args, **kw)
        seen.append(srv.pages["ssm_h"][:, 0].clone())
        return out
    srv._prefill = record
    srv.run(reqs)
    _, _, fresh = T.forward(params, {"tokens": torch.from_numpy(
        reqs[1].prompt[None].astype(np.int64))}, CFG, return_cache=True)
    diff = float((seen[1] - fresh["ssm"]["h"][:, 0]).abs().max())
    assert (diff > 1e-3) if stale else (diff <= 1e-5), diff


@pytest.mark.parametrize("dispatch", ["grouped", "dense"])
@pytest.mark.parametrize("fault", [False, True], ids=["sound", "dropped"])
def test_one_favoured_expert_drops_nothing(params, monkeypatch, dispatch,
                                           fault):
    """Every token's router prefers expert 0 (its column raised, the
    inputs positive): all 24 tokens choose it,
    which a capacity of top_k x tokens x 1.25 / experts = 11 would drop.
    The dropless layer equals the reference's. Planted: the choices of
    expert 0 dropped (their gates zeroed), as a capacity would."""
    p = dict(T.hybrid_moe_layers(params, CFG)[0][2]["moe"])
    p["router"] = p["router"].clone()
    p["router"][:, 0] += 0.06                  # about +3 on its logit
    x = torch.randn(24, SMALL["hidden_size"],
                    generator=torch.Generator().manual_seed(1)).abs()
    _, idx = M.route_topk(p, x, CFG)
    assert bool((idx == 0).any(dim=1).all())
    assert M.capacity(24, CFG) < 24
    if fault:
        route = M.route_topk

        def drop_favoured(p_, xt, cfg):
            gates, ids = route(p_, xt, cfg)
            return torch.where(ids == 0, 0.0, gates), ids
        monkeypatch.setattr(M, "route_topk", drop_favoured)
    if dispatch == "grouped":
        monkeypatch.setattr(M, "DENSE_MAX_ROWS", 0)
    got = M.moe_dropless(p, x, CFG)
    want = REF.moe(p, x, SMALL, "fp32")
    diff = float((got - want).abs().max())
    assert (diff > 1e-3) if fault else (diff <= 1e-5), diff


def test_mamba2_without_gated_norm_is_the_plain_mixer():
    """mamba2-2.7b keeps its mixer: no norm leaf, and its output is the
    reference recurrence's ``y * silu(z)`` through ``out_proj``, in
    prefill and in decode, one token at a time."""
    cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"),
                              compute_dtype="float32")
    assert not cfg.ssm_gated_norm
    g = torch.Generator().manual_seed(2)
    p = S.init_ssm(cfg, g)
    assert "ln_out" not in p
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=g)
    s = cfg.ssm
    ref_cfg = {"hidden_size": cfg.d_model, "num_attention_heads": 1,
               "num_key_value_heads": 1, "num_hidden_layers": 1,
               "layer_types": ["mamba"], "num_local_experts": 1,
               "num_experts_per_tok": 1,
               "mamba_n_heads": s.expand * cfg.d_model // s.head_dim,
               "mamba_d_head": s.head_dim, "mamba_d_state": s.state_dim,
               "mamba_d_conv": s.conv_width, "rms_norm_eps": cfg.norm_eps}
    u = torch.randn(2, 32, cfg.d_model, generator=g)
    want = REF.mamba(p, u, ref_cfg, "fp32")
    got, _ = S.ssm_forward(p, u, cfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    cache = S.init_ssm_cache(2, cfg)
    steps = [S.ssm_decode(p, u[:, t:t + 1], cache, cfg)[0]
             for t in range(u.shape[1])]
    torch.testing.assert_close(torch.cat(steps, 1), want, atol=1e-5,
                               rtol=1e-4)


def test_inactive_rows_keep_their_state_in_decode(params):
    """``ssm_decode`` with an active mask: the inactive row's state and
    conv tail are written back bit for bit."""
    bp = T.hybrid_moe_layers(params, CFG)[0][2]
    cache = {k: torch.randn(v.shape, generator=torch.Generator()
                            .manual_seed(5)).to(v.dtype)
             for k, v in S.init_ssm_cache(2, CFG).items()}
    before = {k: v.clone() for k, v in cache.items()}
    u = torch.randn(2, 1, SMALL["hidden_size"])
    S.ssm_decode(bp["ssm"], u, cache, CFG,
                 active=torch.tensor([True, False]))
    for k in cache:
        assert torch.equal(cache[k][1], before[k][1]), k
        assert not torch.equal(cache[k][0], before[k][0]), k
