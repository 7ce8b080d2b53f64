"""seamless-m4t-large-v2 [audio] — enc-dec, 24L each side, d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].  Audio frontend is a
STUB: input_specs supplies precomputed frame embeddings (B, 4096, 1024).
vocab padded 256206 -> 256256 for 16-way TP (loss masks the pad)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    group=("cross",),
    norm="layernorm",
    ffn="gelu",
    enc_layers=24,
    ctx_tokens=4096,
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-tiny",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=510,
        group=("cross",),
        norm="layernorm",
        ffn="gelu",
        enc_layers=2,
        ctx_tokens=16,
        vocab_pad_multiple=16,
    )
