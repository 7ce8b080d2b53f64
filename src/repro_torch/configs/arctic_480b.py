"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) dense d_ff=4864,
MoE 128 experts top-2 (expert d_ff=4864) + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    ffn="moe",
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    moe_dense_residual=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def tiny() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-tiny",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        ffn="moe",
        n_experts=8,
        top_k=2,
        d_ff_expert=96,
        moe_dense_residual=True,
        vocab_pad_multiple=16,
    )
