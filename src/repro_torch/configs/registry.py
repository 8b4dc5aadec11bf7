"""Architecture registry: full production configs + reduced smoke variants.

Every full config reproduces the assignment spec exactly; `smoke()`
returns a same-family reduced variant (<=2 layers, d_model<=512,
<=4 experts) for CPU tests.

The port's own copy of the JAX package's registry: the same ten
configurations, field for field (`tests/test_torch_models.py` checks),
and the port's own, `PORT_ONLY`: granite-4.0-h-small (granitemoehybrid),
whose one-card share `expert_share` cuts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.config import (
    HybridMoeConfig, ModelConfig, MoeConfig, RglruConfig, SsdConfig,
)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    _REGISTRY[fn().name] = fn          # key by the config's canonical name
    return fn


def get_config(name: str) -> ModelConfig:
    key = name if name in _REGISTRY else name.replace("_", "-")
    return _REGISTRY[key]()


def list_archs():
    return sorted(_REGISTRY)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    kw: dict = dict(
        n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=512, vocab=512, head_dim=64,
    )
    if cfg.arch_type == "hybrid":
        kw["n_layers"] = 3            # one full (rec, rec, local_attn) group
        kw["rglru"] = RglruConfig(d_rnn=256, conv_kernel=4)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2,
            n_shared=min(cfg.moe.n_shared, 1), d_expert=128,
            first_k_dense=min(cfg.moe.first_k_dense, 1))
    if cfg.ssd is not None:
        kw["ssd"] = dataclasses.replace(
            cfg.ssd, n_heads=4, head_dim=32, state_dim=16, chunk=16)
        kw["n_heads"] = 4
    if cfg.arch_type == "encdec":
        kw["n_encoder_layers"] = 2
        kw["n_frontend_tokens"] = 16
    if cfg.arch_type == "vlm":
        kw["n_frontend_tokens"] = 16
    if cfg.window:
        kw["window"] = 32
    if cfg.hybrid_moe is not None:
        # one layer of each mixer and a second Mamba-2 one; every expert
        # held, the shared expert twice an expert's width
        kw["n_layers"] = 3
        kw["hybrid_moe"] = dataclasses.replace(
            cfg.hybrid_moe, layer_types=("mamba", "attention", "mamba"),
            experts_held=4, expert_offset=0, d_shared=256)
        kw["moe"] = dataclasses.replace(kw["moe"], n_shared=1)
    return cfg.replace(**kw)


def expert_share(cfg: ModelConfig, *, n_layers: int, experts_held: int,
                 vocab: int, expert_offset: int = 0) -> ModelConfig:
    """One card's share of a `hybrid_moe` deployment: the first `n_layers`
    layers (a pipeline stage), routed experts [expert_offset,
    expert_offset + experts_held) of every MoE layer, and the first
    `vocab` rows of the vocabulary. Every width, the router's width and
    its experts per token stay as published."""
    if cfg.hybrid_moe is None:
        raise ValueError(f"{cfg.name}: not a hybrid_moe configuration")
    if not 0 <= expert_offset < expert_offset + experts_held \
            <= cfg.moe.n_experts:
        end = expert_offset + experts_held
        raise ValueError(f"experts [{expert_offset}, {end}) of "
                         f"{cfg.moe.n_experts}")
    return cfg.replace(
        n_layers=n_layers, vocab=vocab,
        hybrid_moe=dataclasses.replace(
            cfg.hybrid_moe, layer_types=cfg.hybrid_moe.layer_types[:n_layers],
            experts_held=experts_held, expert_offset=expert_offset))


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

@register
def minitron_4b() -> ModelConfig:
    """Pruned Nemotron: squared-ReLU MLP, GQA [arXiv:2407.14679]."""
    return ModelConfig(
        name="minitron-4b", arch_type="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
        mlp_act="squared_relu", source="arXiv:2407.14679")


@register
def nemotron_4_15b() -> ModelConfig:
    """Nemotron-4 15B: GQA, squared-ReLU [arXiv:2402.16819]."""
    return ModelConfig(
        name="nemotron-4-15b", arch_type="dense", n_layers=32, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=24576, vocab=256000,
        mlp_act="squared_relu", source="arXiv:2402.16819")


@register
def deepseek_67b() -> ModelConfig:
    """DeepSeek 67B: llama-arch, GQA [arXiv:2401.02954]."""
    return ModelConfig(
        name="deepseek-67b", arch_type="dense", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=22016, vocab=102400,
        mlp_act="swiglu", source="arXiv:2401.02954")


@register
def granite_3_2b() -> ModelConfig:
    """Granite 3.0 2B base: GQA [hf:ibm-granite/granite-3.0-2b-base]."""
    return ModelConfig(
        name="granite-3-2b", arch_type="dense", n_layers=40, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155,
        mlp_act="swiglu", source="hf:ibm-granite/granite-3.0-2b-base")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@register
def deepseek_moe_16b() -> ModelConfig:
    """DeepSeekMoE 16B: fine-grained, 2 shared + 64 routed top-6, first
    layer dense [arXiv:2401.06066]."""
    return ModelConfig(
        name="deepseek-moe-16b", arch_type="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408 * 8, vocab=102400,
        mlp_act="swiglu",
        moe=MoeConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                      first_k_dense=1),
        source="arXiv:2401.06066")


@register
def qwen3_moe_30b_a3b() -> ModelConfig:
    """Qwen3-30B-A3B: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
    return ModelConfig(
        name="qwen3-moe-30b-a3b", arch_type="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768 * 8, vocab=151936,
        mlp_act="swiglu",
        moe=MoeConfig(n_experts=128, top_k=8, n_shared=0, d_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B")


# ---------------------------------------------------------------------------
# audio enc-dec / VLM (frontends are stubs per DESIGN.md §6)
# ---------------------------------------------------------------------------

@register
def seamless_m4t_medium() -> ModelConfig:
    """SeamlessM4T-medium backbone: 12L enc + 12L dec, multimodal
    [arXiv:2308.11596]. Audio frontend = stub frame embeddings."""
    return ModelConfig(
        name="seamless-m4t-medium", arch_type="encdec", n_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
        mlp_act="gelu", n_encoder_layers=12, cross_attention=True,
        frontend="audio", n_frontend_tokens=4096,
        source="arXiv:2308.11596")


@register
def internvl2_2b() -> ModelConfig:
    """InternVL2-2B language backbone (InternLM2-1.8B dims); InternViT
    frontend = stub patch embeddings [arXiv:2404.16821]."""
    return ModelConfig(
        name="internvl2-2b", arch_type="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553,
        mlp_act="swiglu", frontend="vision", n_frontend_tokens=1024,
        source="arXiv:2404.16821")


# ---------------------------------------------------------------------------
# hybrid / SSM
# ---------------------------------------------------------------------------

@register
def recurrentgemma_9b() -> ModelConfig:
    """RecurrentGemma-9B: RG-LRU + local attention 1:2 (pattern
    rec,rec,local-attn), MQA [arXiv:2402.19427]."""
    return ModelConfig(
        name="recurrentgemma-9b", arch_type="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288,
        vocab=256000, mlp_act="geglu", window=2048,
        layer_pattern=("recurrent", "recurrent", "local_attn"),
        rglru=RglruConfig(d_rnn=4096, conv_kernel=4),
        source="arXiv:2402.19427")


@register
def mamba2_1_3b() -> ModelConfig:
    """Mamba2-1.3B: SSD, 48 layers, attention-free [arXiv:2405.21060]."""
    return ModelConfig(
        name="mamba2-1.3b", arch_type="ssm", n_layers=48, d_model=2048,
        n_heads=64, n_kv_heads=0, d_ff=0, vocab=50280,
        ssd=SsdConfig(state_dim=128, head_dim=64, n_heads=64, n_groups=1,
                      chunk=128, conv_kernel=4, expand=2),
        source="arXiv:2405.21060")


# granite-4.0-h-small's published `layer_types`: attention at 5, 15, 25, 35
GRANITE_4_LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                              for i in range(40))


@register
def granite_4_0_h_small() -> ModelConfig:
    """Granite 4.0-H Small (32B-A9B, granitemoehybrid): 40 layers, 36
    Mamba-2 and 4 NoPE GQA attention mixers, each followed by a MoE of 72
    SwiGLU experts of width 768, top-10, and one shared expert of width
    1536; muP multipliers, tied embeddings
    [hf:ibm-granite/granite-4.0-h-small]."""
    return ModelConfig(
        name="granite-4.0-h-small", arch_type="hybrid_moe", n_layers=40,
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=768,
        vocab=100352, mlp_act="swiglu", norm_eps=1e-5, tie_embeddings=True,
        moe=MoeConfig(n_experts=72, top_k=10, n_shared=1, d_expert=768,
                      router_aux_weight=0.0, router_z_weight=0.0),
        ssd=SsdConfig(state_dim=128, head_dim=64, n_heads=128, n_groups=1,
                      chunk=256, conv_kernel=4, expand=2),
        hybrid_moe=HybridMoeConfig(
            layer_types=GRANITE_4_LAYER_TYPES, experts_held=72, d_shared=1536,
            embedding_multiplier=12.0, residual_multiplier=0.22,
            logits_scaling=16.0, attention_multiplier=0.0078125),
        source="hf:ibm-granite/granite-4.0-h-small")


# the port's own configurations, beyond the reference's ten
PORT_ONLY = ("granite-4.0-h-small",)

ASSIGNED = [
    "minitron-4b", "deepseek-moe-16b", "nemotron-4-15b", "qwen3-moe-30b-a3b",
    "seamless-m4t-medium", "internvl2-2b", "recurrentgemma-9b",
    "deepseek-67b", "granite-3-2b", "mamba2-1.3b",
]
