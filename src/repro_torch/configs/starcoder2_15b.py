"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; GQA + RoPE, LayerNorm + GELU MLP, biases [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    norm="layernorm",
    ffn="gelu",
    rope_theta=100_000.0,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        norm="layernorm",
        ffn="gelu",
        rope_theta=100_000.0,
        vocab_pad_multiple=16,
    )
