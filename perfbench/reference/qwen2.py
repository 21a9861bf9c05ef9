"""Plain Qwen2-style decoder in float32, written from the configuration.

Per layer: x + attn(norm(x)), then x + mlp(norm(x)), where norm is RMS
normalisation scaled by ``1 + scale``; attention has q, k, v biases,
grouped-query heads, rotary position embedding on interleaved pairs
(``x[..., 0::2], x[..., 1::2]``, the configuration's ``rope_layout``) with
base ``rope_theta``, causal softmax in float32; the MLP is SwiGLU
(``silu(h Wg) * (h Wu)``, then ``Wd``). A final norm, then the untied
unembedding. Weights are the benchmark's tree (the program's key names):
``embed.tok`` (V, d), ``embed.unembed`` (d, V), ``ln_f``, and per layer,
stacked on a leading axis, ``ln1``, ``attn.{wq, wk, wv}`` (d, heads, hd),
``attn.{bq, bk, bv}``, ``attn.wo`` (h, hd, d), ``ln2``, ``mlp.{w_up,
w_gate}`` (d, f), ``mlp.w_down`` (f, d).

``logits`` runs layer by layer, each layer's weights cast to float32 only
while it runs, so the full-depth model fits beside nothing else.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.precision import exact_fp32, matmul


def dims(cfg: Dict) -> Dict[str, int]:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "k": int(cfg["num_key_value_heads"]),
            "hd": int(cfg.get("head_dim", d // h)),
            "L": int(cfg["num_hidden_layers"])}


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, theta: float):
    """x (B, S, heads, hd), positions 0..S-1, interleaved pairs."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def layer(lp: Dict, x, cfg: Dict, mode: str = "fp32"):
    """One decoder layer on x (B, S, d) float32; ``lp`` the layer's leaves."""
    m = dims(cfg)
    eps = float(cfg["rms_norm_eps"])
    b, s, d = x.shape
    a = lp["attn"]
    h = rms_norm(x, lp["ln1"], eps)

    def proj(w, bias, heads):
        y = matmul(h, w.float().reshape(d, heads * m["hd"]), mode)
        return y.reshape(b, s, heads, m["hd"]) + bias.float()

    q = rope(proj(a["wq"], a["bq"], m["h"]), float(cfg["rope_theta"]))
    k = rope(proj(a["wk"], a["bk"], m["k"]), float(cfg["rope_theta"]))
    v = proj(a["wv"], a["bv"], m["k"])
    g = m["h"] // m["k"]
    q = q.reshape(b, s, m["k"], g, m["hd"]).permute(0, 2, 3, 1, 4)
    k = k.permute(0, 2, 1, 3)[:, :, None]
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = matmul_batched(q, k.transpose(-1, -2), mode) / math.sqrt(m["hd"])
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = matmul_batched(torch.softmax(scores, dim=-1), v, mode)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, m["h"] * m["hd"])
    x = x + matmul(out, a["wo"].float().reshape(m["h"] * m["hd"], d), mode)
    h = rms_norm(x, lp["ln2"], eps)
    mp = lp["mlp"]
    up = matmul(h, mp["w_up"].float(), mode)
    gate = matmul(h, mp["w_gate"].float(), mode)
    return x + matmul(F.silu(gate) * up, mp["w_down"].float(), mode)


def matmul_batched(a, b, mode: str):
    """``a @ b`` over leading batch axes, products at ``mode``."""
    return matmul(a, b, mode)


def layer_params(params: Dict, i: int) -> Dict:
    blocks = params["blocks"]
    return {"ln1": blocks["ln1"][i], "ln2": blocks["ln2"][i],
            "attn": {k: v[i] for k, v in blocks["attn"].items()},
            "mlp": {k: v[i] for k, v in blocks["mlp"].items()}}


def forward(params: Dict, tokens: torch.Tensor, cfg: Dict,
            mode: str = "fp32"):
    """Logits (B, S, V) float32 of ``tokens`` (B, S), differentiable in
    the float32 leaves of ``params``."""
    x = params["embed"]["tok"].float()[tokens.long()]
    for i in range(dims(cfg)["L"]):
        x = layer(layer_params(params, i), x, cfg, mode)
    x = rms_norm(x, params["ln_f"], float(cfg["rms_norm_eps"]))
    return matmul(x, params["embed"]["unembed"].float(), mode)


def train_loss(params: Dict, batch: Dict, cfg: Dict, mode: str = "fp32"):
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    logp = torch.log_softmax(forward(params, batch["tokens"], cfg, mode), -1)
    return -logp.gather(-1, batch["labels"].long()[..., None]).mean()


def is_head(path) -> bool:
    """No leaf is a merged-FC head: every leaf takes the groups'
    sub-steps."""
    return False


@torch.no_grad()
def sequence_logits(params: Dict, seqs: List[torch.Tensor], cfg: Dict,
                    modes=("fp32",)) -> Dict[str, List[torch.Tensor]]:
    """Float32 logits (S_i, V) of each sequence in ``seqs`` (1-D token
    tensors), for each precision in ``modes``, computed layer by layer:
    each layer's weights are cast once for all sequences and dropped."""
    out = {}
    with exact_fp32():
        for mode in modes:
            xs = [params["embed"]["tok"][s.long()].float()[None] for s in seqs]
            for i in range(dims(cfg)["L"]):
                lp = _cast(layer_params(params, i))
                xs = [layer(lp, x, cfg, mode) for x in xs]
                del lp
            un = params["embed"]["unembed"].float()
            eps = float(cfg["rms_norm_eps"])
            out[mode] = [matmul(rms_norm(x, params["ln_f"], eps), un, mode)[0]
                         for x in xs]
            del un
    return out


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.float()
