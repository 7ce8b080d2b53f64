"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attn image layers every 5th (8 total)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Vision frontend is a STUB:
input_specs supplies precomputed patch embeddings (B, 6400, 4096)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    group=("attn", "attn", "attn", "cross", "attn"),
    rope_theta=500_000.0,
    ctx_tokens=6400,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-tiny",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        group=("attn", "attn", "attn", "cross", "attn"),
        n_groups=1,
        rope_theta=500_000.0,
        ctx_tokens=16,
        vocab_pad_multiple=16,
    )
