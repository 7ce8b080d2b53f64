"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783; unverified].  The memory/collective stress
cell: bf16 params + bf16 Adam states (see DESIGN §6) under FSDP+TP."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-tiny",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        rope_theta=500_000.0,
        vocab_pad_multiple=16,
    )
