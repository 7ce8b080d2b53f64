"""moonlight-16b-a3b [moe] — Moonlight-16B-A3B as published
(hf:moonshotai/Moonlight-16B-A3B, config.json; DeepSeek-V3's layer): 27
layers at d_model=2048, the first with a dense SwiGLU (d_ff=11264), the
other 26 with 64 routed experts top-6 (expert d_ff=1408) beside 2 shared
experts; every layer latent attention (MLA): 16 heads, no query
low-rank, a key/value latent of 512 plus one 64-wide rope key shared by the
heads, query/key heads 128 + 64, value heads 128; sigmoid router whose
per-expert bias only selects (noaux_tc, one group), gates renormalised and
scaled by 2.446; RMSNorm eps 1e-5; rope theta 50000; vocab=163840, untied.
15.96 B parameters (31.9 GB in bf16)."""
from repro_torch.models.config import ExtendedConfig

CONFIG = ExtendedConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    d_head=128,
    lead=("mla_dense",),
    group=("mla",),
    ffn="moe",
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    router="sigmoid",
    routed_scale=2.446,
    kv_lora_rank=512,
    qk_rope_dim=64,
    rope_theta=50_000.0,
    norm_eps=1e-5,
)


def tiny() -> ExtendedConfig:
    """The same kinds of part at CPU-test size: the leading dense layer,
    two MoE layers of 8 experts (top-3, 2 shared), latent attention with a
    rank under the heads' width; two heads at the published head widths
    (128 + 64), so the card runs the same flash instantiation."""
    return ExtendedConfig(
        name="moonlight-16b-a3b-tiny",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        d_head=128,
        lead=("mla_dense",),
        group=("mla",),
        ffn="moe",
        n_experts=8,
        top_k=3,
        d_ff_expert=32,
        n_shared_experts=2,
        router="sigmoid",
        routed_scale=2.446,
        kv_lora_rank=32,
        qk_rope_dim=64,
        rope_theta=50_000.0,
        norm_eps=1e-5,
        vocab_pad_multiple=16,
    )
