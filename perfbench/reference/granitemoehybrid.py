"""Plain Granite 4.0-H (``granitemoehybrid``) decoder in float32, written
from the configuration.

The layers are ``layer_types[:num_hidden_layers]``, each "mamba" or
"attention". With r = ``residual_multiplier``:

    x = embed(ids) * embedding_multiplier
    per layer:  x = x + r * mixer(norm(x))
                x = x + r * (moe(norm(x)) + shared(norm(x)))
    logits = norm(x) @ embed.T / logits_scaling          (tied embedding)

- norm: RMS normalisation over the hidden size, eps ``rms_norm_eps``.
- attention: grouped-query, no biases, no position embedding ("nope"),
  a full causal softmax with the scale ``attention_multiplier``.
- Mamba-2 (one group): ``in_proj`` gives [z | xBC | dt]; a depthwise
  causal conv of width ``mamba_d_conv`` with bias over xBC, then SiLU,
  split into x (heads of ``mamba_d_head``), B and C (``mamba_d_state``);
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; token by token,
  ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T`` and
  ``y_t = h_t C_t + D x_t`` from a zero state; then the gated norm
  ``norm(y * silu(z))`` over all channels, and ``out_proj``.
- MoE: the router's logits (no bias), the ``num_experts_per_tok`` largest,
  the softmax over those; each chosen expert computed for each token that
  chose it, ``down(silu(x Wg) * (x Wu))`` at ``intermediate_size``; no
  capacity, nothing dropped. The shared expert is the same SwiGLU at
  ``shared_intermediate_size``.

Departures from the published description, all of layout:

- every norm scales by ``1 + scale`` (the port's form, its scales stored
  as offsets from one), the gated norm too;
- the experts' ``input_linear`` is stored as its two halves, ``w_gate``
  (the first) and ``w_up`` (E, d, f), and ``output_linear`` as ``w_down``
  (E, f, d), all as right-hand operands; the shared expert likewise;
- projections are stored as right-hand operands: ``attn.{wq, wk, wv}``
  (d, heads, hd), ``attn.wo`` (heads, hd, d), ``ssm.in_proj`` (d, ...),
  ``ssm.out_proj`` (d_inner, d), ``ssm.conv_w`` (K, channels).

Weights are the benchmark's tree (the program's key names): ``embed.tok``
(V, d), ``ln_f``, and per kind, stacked on a leading axis in layer order,
``mamba_blocks.{ln1, ssm, ln2, moe}`` and ``attn_blocks.{ln1, attn, ln2,
moe}``. ``sequence_logits`` runs layer by layer, each layer's weights
cast to float32 only while it runs.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.precision import exact_fp32, matmul


def dims(cfg: Dict) -> Dict:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    L = int(cfg["num_hidden_layers"])
    n_heads = int(cfg["mamba_n_heads"])
    p = int(cfg["mamba_d_head"])
    return {"d": d, "h": h, "k": int(cfg["num_key_value_heads"]),
            "hd": d // h, "L": L, "kinds": list(cfg["layer_types"][:L]),
            "E": int(cfg["num_local_experts"]),
            "topk": int(cfg["num_experts_per_tok"]),
            "H": n_heads, "P": p, "N": int(cfg["mamba_d_state"]),
            "d_inner": n_heads * p, "K": int(cfg["mamba_d_conv"])}


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def attention(a: Dict, x, cfg: Dict, mode: str):
    m = dims(cfg)
    b, s, d = x.shape
    hd = m["hd"]

    def proj(w, heads):
        return matmul(x, w.reshape(d, heads * hd), mode).reshape(
            b, s, heads, hd).transpose(1, 2)

    q, k, v = proj(a["wq"], m["h"]), proj(a["wk"], m["k"]), \
        proj(a["wv"], m["k"])
    g = m["h"] // m["k"]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = matmul(q, k.transpose(-1, -2), mode) \
        * float(cfg["attention_multiplier"])
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = matmul(torch.softmax(scores, dim=-1), v, mode)
    out = out.transpose(1, 2).reshape(b, s, m["h"] * hd)
    return matmul(out, a["wo"].reshape(m["h"] * hd, d), mode)


def mamba(p: Dict, x, cfg: Dict, mode: str):
    m = dims(cfg)
    b, s, _ = x.shape
    di, n, H, P = m["d_inner"], m["N"], m["H"], m["P"]
    z, xbc, dt = torch.split(matmul(x, p["in_proj"], mode),
                             [di, di + 2 * n, H], dim=-1)
    w = p["conv_w"]                                       # (K, channels)
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(K)) + p["conv_b"]
    xs, B, C = torch.split(F.silu(conv), [di, n, n], dim=-1)
    xs = xs.reshape(b, s, H, P)
    dt = F.softplus(dt + p["dt_bias"])                   # (b, s, H)
    A = -torch.exp(p["A_log"])
    h = torch.zeros(b, H, P, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t] * A)[:, :, None, None] * h \
            + (dt[:, t, :, None] * xs[:, t])[..., None] * B[:, t, None, None]
        ys.append(torch.einsum("bhpn,bn->bhp", h, C[:, t])
                  + p["D"][:, None] * xs[:, t])
    y = torch.stack(ys, dim=1).reshape(b, s, di) * F.silu(z)
    if "ln_out" in p:                   # the gated norm (Mamba-2 has none)
        y = rms_norm(y, p["ln_out"], float(cfg["rms_norm_eps"]))
    return matmul(y, p["out_proj"], mode)


def swiglu(x, wg, wu, wd, mode: str):
    return matmul(F.silu(matmul(x, wg, mode)) * matmul(x, wu, mode), wd,
                  mode)


def moe(p: Dict, x, cfg: Dict, mode: str):
    m = dims(cfg)
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    logits = matmul(xt, p["router"], mode)
    top, idx = torch.topk(logits, m["topk"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(xt)
    for e in range(m["E"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(xt[rows], p["w_gate"][e], p["w_up"][e],
                         p["w_down"][e], mode)
            y.index_add_(0, rows, gates[rows, slot][:, None] * out)
    sh = p["shared"]
    y = y + swiglu(xt, sh["w_gate"], sh["w_up"], sh["w_down"], mode)
    return y.reshape(shape)


def layer(lp: Dict, kind: str, x, cfg: Dict, mode: str = "fp32"):
    """One layer on x (B, S, d) float32; ``lp`` the layer's leaves."""
    eps = float(cfg["rms_norm_eps"])
    r = float(cfg["residual_multiplier"])
    h = rms_norm(x, lp["ln1"], eps)
    x = x + r * (mamba(lp["ssm"], h, cfg, mode) if kind == "mamba"
                 else attention(lp["attn"], h, cfg, mode))
    return x + r * moe(lp["moe"], rms_norm(x, lp["ln2"], eps), cfg, mode)


def layers(params: Dict, cfg: Dict):
    """(kind, leaves) of each layer, in order."""
    seen = {"mamba": 0, "attention": 0}
    stacks = {"mamba": params["mamba_blocks"],
              "attention": params["attn_blocks"]}
    for kind in dims(cfg)["kinds"]:
        i = seen[kind]
        seen[kind] += 1
        yield kind, _index(stacks[kind], i)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _cast(tree):
    if isinstance(tree, dict):
        return {k: _cast(v) for k, v in tree.items()}
    return tree.float()


def _embed(params: Dict, tokens, cfg: Dict):
    return params["embed"]["tok"].float()[tokens.long()] \
        * float(cfg["embedding_multiplier"])


def _head(params: Dict, x, cfg: Dict, mode: str):
    x = rms_norm(x, params["ln_f"], float(cfg["rms_norm_eps"]))
    return matmul(x, params["embed"]["tok"].float().T, mode) \
        / float(cfg["logits_scaling"])


def forward(params: Dict, tokens: torch.Tensor, cfg: Dict,
            mode: str = "fp32"):
    """Logits (B, S, V) float32 of ``tokens`` (B, S)."""
    x = _embed(params, tokens, cfg)
    for kind, lp in layers(params, cfg):
        x = layer(_cast(lp), kind, x, cfg, mode)
    return _head(params, x, cfg, mode)


@torch.no_grad()
def sequence_logits(params: Dict, seqs: List[torch.Tensor], cfg: Dict,
                    modes=("fp32",)) -> Dict[str, List[torch.Tensor]]:
    """Float32 logits (S_i, V) of each sequence in ``seqs`` (1-D token
    tensors), for each precision in ``modes``. The sequences run as one
    batch, right-padded to the longest (every layer is causal, so a
    sequence's logits do not see its padding), layer by layer: each
    layer's weights are cast once and dropped."""
    n = max(len(s) for s in seqs)
    toks = torch.zeros(len(seqs), n, dtype=torch.long, device=seqs[0].device)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s.long()
    out = {}
    with exact_fp32():
        for mode in modes:
            x = _embed(params, toks, cfg)
            for kind, lp in layers(params, cfg):
                x = layer(_cast(lp), kind, x, cfg, mode)
            logits = _head(params, x, cfg, mode)
            out[mode] = [logits[i, :len(s)] for i, s in enumerate(seqs)]
            del x, logits
    return out
