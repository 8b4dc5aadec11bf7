"""Operations and bytes of a training step of granite-4.0-h-small's
hybrid stack (the `train` driver's cells): the yardstick of `train_mfu`
and `expert_gemm_roofline`.

Model FLOPs of a step are 6 · (active matrix-product parameters) ·
tokens, where the held experts count by the routes that reached them,
plus causal attention's score and value products and the SSD's chunked
products, each a forward and two backward products. The recompute of
remat is not counted, nor elementwise work (norms, gates, the scan's
decays, AdamW). A triangle that a causal mask leaves out is not
counted: half of attention's S x S products and of each SSD chunk's
Q x Q ones.
"""
from __future__ import annotations

from bench.roofline import BF16, HBM

BYTES = 2  # bf16


def dims(c: dict) -> dict:
    """The widths a step's count needs, from a configuration file."""
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    heads, kv = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"]
    hd = d // heads
    return dict(
        d=d, hd=hd, heads=heads, H=H, P=P, N=N, Q=c["mamba_chunk_size"],
        f=c["intermediate_size"], fs=c["shared_intermediate_size"],
        E=c["router_experts"], held=c["num_local_experts"],
        vocab=c["vocab_size"],
        mamba=d * (2 * H * P + 2 * G * N + H) + H * P * d,
        attn=d * heads * hd * 2 + 2 * d * kv * hd,
        kinds=list(c["layer_types"][:c["num_hidden_layers"]]))


def step_flops(c: dict, batch: int, seq: int, routes: float) -> float:
    """A step's model FLOPs at `batch` x `seq` tokens, `routes` the routes
    that reached a held expert over all layers in one forward."""
    m = dims(c)
    T = batch * seq
    n_mamba = m["kinds"].count("mamba")
    n_attn = m["kinds"].count("attention")
    dense = (n_mamba * m["mamba"] + n_attn * m["attn"]
             + len(m["kinds"]) * (3 * m["d"] * m["fs"] + m["d"] * m["E"])
             + m["d"] * m["vocab"])
    experts = routes * 3 * m["d"] * m["f"]
    # causal attention: q·k and p·v over the lower triangle, per head
    attn = n_attn * 2 * batch * m["heads"] * seq * seq * m["hd"]
    # SSD chunks: C Bᵀ and its product with x over each chunk's lower
    # triangle, the chunk states and their output (b, S, H, ·)
    H, P, N, Q = m["H"], m["P"], m["N"], m["Q"]
    ssd = n_mamba * 2 * T * H * (Q * N / 2 + Q * P / 2 + 2 * N * P)
    return 6.0 * (dense * T + experts) + 3.0 * (attn + ssd)


def grouped_products(c: dict, routes: float) -> tuple[float, float]:
    """(FLOPs, bytes) of the held experts' grouped products in one
    training step under remat: each layer's three products run in the
    forward and again in the recompute, and each gives two in the
    backward (the input's and the weights' gradients), twelve a layer;
    each reads its two operands and writes its result once. `routes` as
    in `step_flops`."""
    m = dims(c)
    d, f, layers = m["d"], m["f"], len(m["kinds"])
    flops = 12 * 2.0 * routes * d * f
    nbytes = 12 * BYTES * (routes * (d + f) + layers * m["held"] * d * f)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time on the card, bf16 on the tensor cores."""
    return max(flops / BF16, nbytes / HBM)
