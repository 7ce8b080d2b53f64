"""moonshot-v1-16b-a3b [moe] — the JAX package's 48-layer MHA stand-in
for a Kimi/Moonlight-sized MoE: 48L d_model=2048 16H (kv=16, full K/V
cache), every layer MoE with 64 experts top-6 (expert d_ff=1408), softmax
gates and capacity-factor drops, vocab=163840.  Not Moonlight-16B-A3B's
published architecture (27 layers, latent attention, 2 shared experts, a
sigmoid router, a leading dense layer): that is ``moonlight_16b_a3b``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    ffn="moe",
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    rope_theta=50_000.0,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-tiny",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        ffn="moe",
        n_experts=8,
        top_k=3,
        d_ff_expert=96,
        vocab_pad_multiple=16,
    )
