"""Plain PyTorch reference of granite-4.0-h-small's hybrid stack
(granitemoehybrid, hf:ibm-granite/granite-4.0-h-small): the forward, the
loss and the gradients, in float32 (or, for the control, wholly in a
lower precision), with no kernel, no cache, no capacity and no batching.

It imports torch alone: nothing of the measured program, of JAX or of
the JAX package. Its parameters are the program's tree (`init_params`'
layout: `embed`, `final_norm`, `layers[i]` with `norm1`, `norm2`, `ssd`
or `attn`, and `moe` with `router`, `experts`, `shared`), its settings a
`Spec` (`spec_of` reads them from a configuration, `spec_from_json` from
a benchmark file). Layer i, n(·) an RMSNorm of eps `norm_eps`:

    x_0 = embedding_multiplier · E[tok]
    h = x + r · mixer_i(n(x));  x' = h + r · (moe_held(n(h)) + shared(n(h)))
    logits = n(x_L) Eᵀ / logits_scaling

with r the residual multiplier; the mixer Mamba-2 or attention as
`layer_types` says. Departures from the published description, each
noted where it is made: every RMSNorm's scale is stored as 1 + w (the
program's convention; the published model stores the factor itself);
only the experts held here are computed (`experts_held` from
`expert_offset`), as on one card of an expert-parallel deployment, and
what the others would add is left out; the layers and the attention's
query rows are computed in blocks under `torch.utils.checkpoint`, and the
SSD recurrence, whose derivative is written out (`_Scan`), keeps its
state at the start of each block of time steps and recomputes the block
in its backward: blocks change what is kept for the backward, not what
is computed.

Products run in full float32: TF32 is off in both `torch.backends`
flags while it runs (`no_tf32`).
"""
from __future__ import annotations

import contextlib
import json
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_ROWS = 1024        # query rows a block of the attention
SCAN_STEPS = 256        # time steps a block of the SSD recurrence


@dataclass(frozen=True)
class Spec:
    layer_types: tuple          # "mamba" | "attention", per layer present
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    norm_eps: float
    ssd_heads: int
    ssd_head_dim: int
    ssd_state: int
    ssd_groups: int
    conv_kernel: int
    n_experts: int              # the router's width
    top_k: int
    experts_held: int
    expert_offset: int
    embedding_multiplier: float
    residual_multiplier: float
    logits_scaling: float
    attention_multiplier: float


def spec_of(cfg) -> Spec:
    """The settings of a `hybrid_moe` configuration object (read by
    attribute)."""
    hm, sc, mc = cfg.hybrid_moe, cfg.ssd, cfg.moe
    return Spec(tuple(hm.layer_types[:cfg.n_layers]), cfg.d_model,
                cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim or cfg.d_model // cfg.n_heads, cfg.vocab,
                cfg.norm_eps, sc.n_heads, sc.head_dim, sc.state_dim,
                sc.n_groups, sc.conv_kernel, mc.n_experts, mc.top_k,
                hm.experts_held, hm.expert_offset,
                hm.embedding_multiplier, hm.residual_multiplier,
                hm.logits_scaling, hm.attention_multiplier)


def spec_from_json(c: dict) -> Spec:
    """The settings of a benchmark configuration file (the published
    config.json's keys, cut to one card's share)."""
    return Spec(tuple(c["layer_types"][:c["num_hidden_layers"]]),
                c["hidden_size"], c["num_attention_heads"],
                c["num_key_value_heads"],
                c["hidden_size"] // c["num_attention_heads"],
                c["vocab_size"], c["rms_norm_eps"], c["mamba_n_heads"],
                c["mamba_d_head"], c["mamba_d_state"], c["mamba_n_groups"],
                c["mamba_d_conv"], c["router_experts"],
                c["num_experts_per_tok"], c["num_local_experts"],
                c.get("expert_offset", 0), c["embedding_multiplier"],
                c["residual_multiplier"], c["logits_scaling"],
                c["attention_multiplier"])


@contextlib.contextmanager
def no_tf32():
    """Full float32 products (TF32 off in both flags) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, w, eps: float):
    # departure: the scale is stored as 1 + w, the program's convention
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1 + w)


def softmax(s, dim: int = -1):
    """exp(s − max) over its sum, each step in s's dtype."""
    e = torch.exp(s - torch.amax(s, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _rows(q, k, v, start: int, scale: float):
    """Query rows [start, start + len) of causal softmax(q kᵀ · scale) v:
    each row's whole softmax at once."""
    s = torch.einsum("bsnh,btnh->bnst", q, k) * scale
    i = torch.arange(start, start + q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    s = s.masked_fill(j > i, float("-inf"))
    return torch.einsum("bnst,btnh->bsnh", softmax(s), v)


def attention(p: dict, x, s: Spec):
    """GQA attention with no positional encoding (NoPE) and softmax
    scale `attention_multiplier`, causal."""
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, p["wv"])
    g = s.n_heads // s.n_kv_heads          # query head n reads kv head n // g
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    # departure: query rows in blocks, each block recomputed in the backward
    o = torch.cat([checkpoint(_rows, q[:, a:a + ATTN_ROWS], k, v, a,
                              s.attention_multiplier, use_reentrant=False)
                   for a in range(0, x.shape[1], ATTN_ROWS)], dim=1)
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"])


def _states(h, u, decay, Bm):
    """h_t = decay_t h_{t-1} + u_t ⊗ B_t, one time step after another from
    h: every h_t of the block, (b, s, H, P, N)."""
    hs = []
    for t in range(u.shape[1]):
        h = torch.addcmul(h * decay[:, t, :, None, None],
                          u[:, t, :, :, None], Bm[:, t, :, None, :])
        hs.append(h)
    return torch.stack(hs, dim=1)


class _Scan(torch.autograd.Function):
    """The recurrence and y_t = h_t · C_t, its derivative written out.
    With g_t = ∂L/∂h_t (g_t = dy_t ⊗ C_t + decay_{t+1} g_{t+1}, from the
    last step back): ∂L/∂C_t = h_tᵀ dy_t, ∂L/∂u_t = g_t B_t, ∂L/∂B_t =
    g_tᵀ u_t, ∂L/∂decay_t = Σ g_t ⊙ h_{t-1}. The states are walked one
    step at a time; the products with them are taken a block of
    `SCAN_STEPS` steps at once. The forward keeps h at the start of each
    block, the backward recomputes the block's states from it (departure:
    blocks, which change what is kept, not what is computed)."""

    @staticmethod
    def forward(ctx, u, decay, Bm, Cm):
        b, S, H, P = u.shape
        h = u.new_zeros((b, H, P, Bm.shape[-1]))
        starts, ys = [], []
        for a in range(0, S, SCAN_STEPS):
            sl = slice(a, a + SCAN_STEPS)
            starts.append(h)
            hs = _states(h, u[:, sl], decay[:, sl], Bm[:, sl])
            ys.append(torch.einsum("bshpn,bshn->bshp", hs, Cm[:, sl]))
            h = hs[:, -1].clone()        # not a view that keeps the block
        ctx.save_for_backward(u, decay, Bm, Cm, *starts)
        return torch.cat(ys, dim=1)

    @staticmethod
    def backward(ctx, dy):
        u, decay, Bm, Cm, *starts = ctx.saved_tensors
        S = u.shape[1]
        grads = [], [], [], []
        g = torch.zeros_like(starts[0])
        for j in reversed(range(len(starts))):
            sl = slice(j * SCAN_STEPS, min((j + 1) * SCAN_STEPS, S))
            hs = _states(starts[j], u[:, sl], decay[:, sl], Bm[:, sl])
            gs = []
            for t in reversed(range(sl.start, sl.stop)):
                if t + 1 < S:
                    g = g * decay[:, t + 1, :, None, None]
                g = torch.addcmul(g, dy[:, t, :, :, None],
                                  Cm[:, t, :, None, :])
                gs.append(g)
            gs = torch.stack(gs[::-1], dim=1)
            prev = torch.cat([starts[j][:, None], hs[:, :-1]], dim=1)
            for out, grad in zip(grads, (
                    torch.einsum("bshpn,bshn->bshp", gs, Bm[:, sl]),
                    torch.sum(gs * prev, dim=(-2, -1)),
                    torch.einsum("bshpn,bshp->bshn", gs, u[:, sl]),
                    torch.einsum("bshpn,bshp->bshn", hs, dy[:, sl]))):
                out.insert(0, grad)
        return tuple(torch.cat(x, dim=1) for x in grads)


def ssd_scan(xs, dt, A, Bm, Cm):
    """The selective state space recurrence, sequential in time, its
    state in xs's dtype from zero: xs (b, S, H, P), dt (b, S, H), A (H,),
    Bm, Cm (b, S, H, N) -> y (b, S, H, P)."""
    return _Scan.apply(xs * dt[..., None], torch.exp(dt * A), Bm, Cm)


def mamba(p: dict, x, s: Spec):
    """Mamba-2: in_proj -> [z, xBC, dt]; xBC = silu(conv(xBC) + b), the
    causal depthwise conv of `conv_kernel` taps; dt = softplus(dt +
    dt_bias); A = -exp(A_log); the recurrence with the D skip; out_proj of
    the gated RMSNorm rmsnorm(y · silu(z)) over each group's channels."""
    H, P, N, G = s.ssd_heads, s.ssd_head_dim, s.ssd_state, s.ssd_groups
    b, S, _ = x.shape
    d_in = H * P
    z, xbc, dt = torch.split(x @ p["w_in"], [d_in, d_in + 2 * G * N, H],
                             dim=-1)
    k = s.conv_kernel
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(p["conv_w"][i] * xp[:, i:i + S] for i in range(k))
    xs, Bm, Cm = torch.split(F.silu(conv + p["conv_b"]), [d_in, G * N, G * N],
                             dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xs = xs.reshape(b, S, H, P)
    Bm = Bm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
    y = ssd_scan(xs, dt, A, Bm, Cm) + xs * p["D"][:, None]
    g = (y.reshape(b, S, d_in) * F.silu(z)).reshape(b, S, G, d_in // G)
    g = rms_norm(g, 0.0, s.norm_eps).reshape(b, S, d_in) * (1 + p["norm"])
    return g @ p["w_out"]


def moe_held(p: dict, x, s: Spec, routes=None):
    """The routed experts held here: the router over all `n_experts`, the
    gates the softmax of each token's `top_k` largest logits, and for
    each held expert the tokens that chose it, every one of them (no
    capacity), through its SwiGLU, weighted by its gate and added. Each
    token's chosen experts (T, top_k) are appended to `routes`, a list,
    where one is given."""
    b, S, d = x.shape
    xf = x.reshape(b * S, d)
    top_v, top_i = torch.topk(xf @ p["router"], s.top_k, dim=-1)
    if routes is not None:
        routes.append(top_i)
    gates = softmax(top_v)
    out = torch.zeros_like(xf)
    e = p["experts"]
    # departure: the experts held elsewhere are not computed
    for j in range(s.experts_held):
        hit = top_i == s.expert_offset + j
        rows = torch.nonzero(hit.any(dim=-1))[:, 0]
        y = swiglu(xf[rows], e["w_gate"][j], e["w_up"][j], e["w_down"][j])
        out = out.index_add(0, rows, y * (gates * hit).sum(-1)[rows, None])
    return out.reshape(b, S, d)


def layer(p: dict, x, kind: str, s: Spec, routes=None):
    r = s.residual_multiplier
    xn = rms_norm(x, p["norm1"], s.norm_eps)
    h = x + r * (mamba(p["ssd"], xn, s) if kind == "mamba"
                 else attention(p["attn"], xn, s))
    hn = rms_norm(h, p["norm2"], s.norm_eps)
    sh = p["moe"]["shared"]
    return h + r * (moe_held(p["moe"], hn, s, routes)
                    + swiglu(hn, sh["w_gate"], sh["w_up"], sh["w_down"]))


def forward(params: dict, s: Spec, tokens: torch.Tensor, routes=None):
    """Logits (B, S, vocab) in the parameters' dtype; each layer's routes
    appended to `routes` where a list is given (`moe_held`)."""
    x = params["embed"][tokens] * s.embedding_multiplier
    for p, kind in zip(params["layers"], s.layer_types):
        # departure: each layer recomputed in the backward
        x = checkpoint(layer, p, x, kind, s, routes, use_reentrant=False)
    x = rms_norm(x, params["final_norm"], s.norm_eps)
    return (x @ params["embed"][:s.vocab].T) / s.logits_scaling


def loss_of(logits, labels):
    """Mean cross entropy over the labels >= 0, in the logits' dtype."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    return torch.sum((lse - ll) * mask) / mask.sum().clamp_min(1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(t, leaves, f"{prefix}{i}/") for i, t in enumerate(tree)]
    return leaves[prefix[:-1]]


def loss_and_grads(params: dict, s: Spec, tokens, labels,
                   dtype=torch.float32):
    """(loss, {leaf path: gradient}) of the parameters cast to `dtype`,
    every step computed in `dtype`; the loss and the gradients returned
    in float32. Leaf paths are "/"-joined keys and list indices."""
    named = {k: v.detach().to(dtype).requires_grad_()
             for k, v in _leaves(params)}
    with no_tf32():
        loss = loss_of(forward(_rebuild(params, named), s, tokens), labels)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    return loss.detach().float(), {
        k: (torch.zeros_like(v) if g is None else g).float()
        for (k, v), g in zip(named.items(), grads)}


def logits_of(params: dict, s: Spec, tokens, dtype=torch.float32,
              routes=None):
    """The full forward's logits of the parameters cast to `dtype` (each
    layer's routes appended to `routes` where a list is given)."""
    named = {k: v.detach().to(dtype) for k, v in _leaves(params)}
    with no_tf32(), torch.no_grad():
        return forward(_rebuild(params, named), s, tokens, routes)


def learning_rate(step: int, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    """The schedule at optimiser step `step` (from 0): linear warm-up to
    `peak_lr` over `warmup` steps, then a cosine to floor · peak_lr at
    `total`."""
    if step < warmup:
        return peak_lr * (step + 1) / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi
                                                                * frac)))


def adamw_changes(grads: dict, master: dict, mu: dict, nu: dict, count: int,
                  lr: float, *, b1: float = 0.9, b2: float = 0.95,
                  eps: float = 1e-8, weight_decay: float = 0.1,
                  clip_norm: float = 1.0):
    """AdamW's change to each weight, in float64, leaf by leaf: yields
    (leaf path, Δw) for the gradients `grads` (on their device) and the
    state before the step, `master`, `mu`, `nu` by leaf path (on any
    device) after `count` steps. The gradients are scaled by min(1,
    clip_norm / ‖g‖), ‖g‖ over every leaf; then m = b1 m + (1 − b1) g, v =
    b2 v + (1 − b2) g², and Δw = −lr (m / c1) / (√(v / c2) + eps) − lr ·
    weight_decay · w, with c = 1 − b^(count + 1)."""
    f64 = torch.float64
    norm = math.sqrt(sum(float(torch.sum(torch.square(g.to(f64))))
                         for g in grads.values()))
    scale = min(1.0, clip_norm / max(norm, 1e-9))
    t = count + 1
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    for k, g in grads.items():
        dev = g.device
        g = g.to(f64) * scale
        m = b1 * mu[k].to(dev, f64) + (1 - b1) * g
        v = b2 * nu[k].to(dev, f64) + (1 - b2) * g * g
        yield k, (-lr * (m / c1) / (torch.sqrt(v / c2) + eps)
                  - lr * weight_decay * master[k].to(dev, f64))


def load_spec(path) -> Spec:
    with open(path) as f:
        return spec_from_json(json.load(f))
