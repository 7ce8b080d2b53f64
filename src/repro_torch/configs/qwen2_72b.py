"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-tiny",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        vocab_pad_multiple=16,
    )
