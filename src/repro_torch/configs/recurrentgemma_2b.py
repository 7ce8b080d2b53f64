"""recurrentgemma-2b [hybrid] — Griffin 1:2: 26L d_model=2560 10H (MQA kv=1)
d_ff=7680, RG-LRU width 2560, local attn window 2048 [arXiv:2402.19427; hf].
Pattern (R,R,A)x8 + (R,R).  Sub-quadratic: runs the long_500k cell."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    group=("rglru", "rglru", "attn"),
    tail=("rglru", "rglru"),
    ffn="geglu",
    window=2048,
    d_rnn=2560,
    conv_width=4,
    rope_theta=10_000.0,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-tiny",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        d_head=32,
        d_ff=128,
        vocab_size=512,
        group=("rglru", "rglru", "attn"),
        n_groups=1,
        tail=("rglru", "rglru"),
        ffn="geglu",
        window=8,
        d_rnn=64,
        conv_width=4,
        vocab_pad_multiple=16,
    )
