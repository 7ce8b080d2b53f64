"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free, 64 heads of 64)
d_ff=14336 vocab=65536; data-dependent decay [arXiv:2404.05892; hf].
Sub-quadratic: runs the long_500k cell."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab_size=65536,
    group=("rwkv",),
    norm="layernorm",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-tiny",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        group=("rwkv",),
        norm="layernorm",
        vocab_pad_multiple=16,
    )
