"""Model configuration for the backbone zoo.

One frozen dataclass describes every assigned architecture family:
dense decoders, MoE decoders, encoder-decoder (audio), VLM decoders,
hybrid RG-LRU/local-attention (Griffin-style), and Mamba-2 SSD.

The port's own copy of the JAX package's `models/config.py`, letter for
letter, with one family of its own: `hybrid_moe` (granitemoehybrid), whose
layers are (mixer, FFN) pairs, `ssd+moe` or `attn+moe`, in the order its
published `layer_types` gives, every FFN a dropless MoE over the experts
held here with a shared expert of its own width (`HybridMoeConfig`,
`ModelConfig.hybrid_moe`, None for the ten families of the reference).
It is pure Python, but the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Tuple

ArchType = Literal["dense", "moe", "encdec", "vlm", "hybrid", "ssm",
                   "hybrid_moe"]
MlpAct = Literal["swiglu", "squared_relu", "geglu", "gelu"]
LayerKind = Literal["attn", "local_attn", "recurrent", "ssd", "moe",
                    "ssd+moe", "attn+moe"]


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 2
    n_shared: int = 0             # shared (always-on) experts
    d_expert: int = 0             # ffn width per expert
    capacity_factor: float = 1.25
    first_k_dense: int = 0        # leading dense layers (deepseek-moe uses 1)
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4


@dataclass(frozen=True)
class SsdConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    n_heads: int = 0              # H  (d_inner = H * P)
    n_groups: int = 1             # G  (B/C projection groups)
    chunk: int = 128              # SSD chunk length
    conv_kernel: int = 4
    expand: int = 2


@dataclass(frozen=True)
class RglruConfig:
    d_rnn: int = 0                # RG-LRU width (defaults to d_model)
    conv_kernel: int = 4
    c: float = 8.0                # Griffin's fixed recurrence-sharpness const


@dataclass(frozen=True)
class HybridMoeConfig:
    """granitemoehybrid's layer pairs and multipliers (the port's own).

    Layer i's mixer is Mamba-2 (`"mamba"`: the SSD block with a bias on
    its depthwise conv and the gated RMSNorm before `out_proj`) or GQA
    attention (`"attention"`: no rotary embedding, softmax scale
    `attention_multiplier`); its FFN is a MoE whose router spans
    all `moe.n_experts` experts and keeps `moe.top_k`, of which experts
    [expert_offset, expert_offset + experts_held) are held here and
    computed without dropping a token, beside one shared SwiGLU expert
    of width `d_shared`. The multipliers: the embedding times
    `embedding_multiplier`, each residual branch times
    `residual_multiplier`, the logits divided by `logits_scaling`."""
    layer_types: Tuple[str, ...] = ()  # "mamba" | "attention", per layer
    experts_held: int = 0              # routed experts held here
    expert_offset: int = 0             # the first of them
    d_shared: int = 0                  # the shared expert's width
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0  # softmax scale; 0 -> 1/sqrt(H)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    mlp_act: MlpAct = "swiglu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    window: int = 0                        # 0 = full attention, else sliding
    # --- family-specific ---
    moe: Optional[MoeConfig] = None
    ssd: Optional[SsdConfig] = None
    rglru: Optional[RglruConfig] = None
    layer_pattern: Tuple[LayerKind, ...] = ()   # hybrid repeat pattern
    # encoder-decoder (audio) — n_layers refers to EACH stack
    n_encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stubs (see DESIGN.md §6)
    frontend: Optional[Literal["audio", "vision"]] = None
    n_frontend_tokens: int = 0             # patches / frames fed by the stub
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # vocab rows are padded to this multiple so embedding/head/logits shard
    # cleanly over the (data x model) mesh — production frameworks always
    # pad the vocab. CE masks the pad columns (loss is exact).
    vocab_pad_multiple: int = 256
    # citation for the config provenance
    source: str = ""
    # the port's own family: None for the reference's ten
    hybrid_moe: Optional[HybridMoeConfig] = None

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter counting (used for roofline MODEL_FLOPS = 6*N*D)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        return (self.d_model * self.n_heads * hd          # q
                + 2 * self.d_model * self.n_kv_heads * hd  # k, v
                + self.n_heads * hd * self.d_model)        # o

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _layer_params(self, kind: LayerKind) -> int:
        d = self.d_model
        if kind in ("attn", "local_attn"):
            return self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
        if kind == "moe":
            mc = self.moe
            routed = mc.n_experts * self._mlp_params(mc.d_expert)
            shared = self._mlp_params(mc.n_shared * mc.d_expert)
            router = d * mc.n_experts
            return self._attn_params() + routed + shared + router + 2 * d
        if kind == "recurrent":
            rc = self.rglru
            dr = rc.d_rnn or d
            # in/gate proj, conv, gates, out proj + mlp
            rec = 2 * d * dr + rc.conv_kernel * dr + 2 * dr * dr + 2 * dr + dr * d
            return rec + self._mlp_params(self.d_ff) + 2 * d
        if kind == "ssd":
            sc = self.ssd
            d_in = sc.n_heads * sc.head_dim
            proj_in = d * (2 * d_in + 2 * sc.n_groups * sc.state_dim + sc.n_heads)
            conv = sc.conv_kernel * (d_in + 2 * sc.n_groups * sc.state_dim)
            return proj_in + conv + 2 * sc.n_heads + d_in * d + 2 * d
        if kind in ("ssd+moe", "attn+moe"):
            return self._mixer_params(kind) + self._held_moe_params() + 2 * d
        raise ValueError(kind)

    def _mixer_params(self, kind: LayerKind) -> int:
        """A `hybrid_moe` layer's mixer: Mamba-2 with its conv bias and
        gated norm, or attention."""
        if kind == "attn+moe":
            return self._attn_params()
        sc = self.ssd
        d_in = sc.n_heads * sc.head_dim
        conv_dim = d_in + 2 * sc.n_groups * sc.state_dim
        # the conv's bias and the gated norm's scale
        return self._layer_params("ssd") - 2 * self.d_model + conv_dim + d_in

    def _held_moe_params(self) -> int:
        """A `hybrid_moe` layer's FFN as held here: the held experts, the
        shared expert and the router over every expert."""
        mc, hm = self.moe, self.hybrid_moe
        return (hm.experts_held * self._mlp_params(mc.d_expert)
                + self._mlp_params(hm.d_shared) + self.d_model * mc.n_experts)

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """The concrete per-layer kind list for the decoder stack."""
        if self.arch_type == "ssm":
            return ("ssd",) * self.n_layers
        if self.arch_type == "hybrid":
            pat = self.layer_pattern or ("recurrent", "recurrent", "local_attn")
            reps = -(-self.n_layers // len(pat))
            return (pat * reps)[: self.n_layers]
        if self.arch_type == "moe":
            fk = self.moe.first_k_dense
            return ("attn",) * fk + ("moe",) * (self.n_layers - fk)
        if self.arch_type == "hybrid_moe":
            kinds = {"mamba": "ssd+moe", "attention": "attn+moe"}
            return tuple(kinds[t] for t in
                         self.hybrid_moe.layer_types[:self.n_layers])
        return ("attn",) * self.n_layers

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        n = sum(self._layer_params(k) for k in self.layer_kinds())
        if self.arch_type == "encdec" or self.cross_attention:
            # encoder stack + per-decoder-layer cross attention
            n += self.n_encoder_layers * (
                self._attn_params() + self._mlp_params(self.d_ff) + 2 * d)
            n += self.n_layers * (self._attn_params() + d)
        n += v * d * (1 if self.tie_embeddings else 2)  # embed (+ head)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only; for
        `hybrid_moe`, the token's routes that reach a held expert counted
        as top_k · held / n_experts of them)."""
        if self.arch_type == "hybrid_moe":
            mc, hm = self.moe, self.hybrid_moe
            unused = (hm.experts_held - mc.top_k * hm.experts_held
                      / mc.n_experts) * self._mlp_params(mc.d_expert)
            return round(self.param_count() - self.n_layers * unused)
        if self.arch_type != "moe":
            return self.param_count()
        mc = self.moe
        full = self.param_count()
        routed_total = (self.n_layers - mc.first_k_dense) * mc.n_experts \
            * self._mlp_params(mc.d_expert)
        routed_active = (self.n_layers - mc.first_k_dense) * mc.top_k \
            * self._mlp_params(mc.d_expert)
        return full - routed_total + routed_active
