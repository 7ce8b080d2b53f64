"""Model configuration — a copy of the JAX package's ``models/config.py``.

``ModelConfig`` is the same dataclass (derived properties and analytic
parameter counts), so a config module reads the same in both packages.
``param_dtype`` is the dtype of the trainable model's master
weights; the serving model stores each weight in the dtype the JAX model
uses it in (see ``model.py``).  A model is a stack of *blocks* arranged as
``group * n_groups + tail``; the port runs them as one ``nn.ModuleList`` in
pattern order.  Block kinds:

  * ``attn``  — self-attention (GQA/MQA, optional window/bias) + FFN
  * ``cross`` — self-attention + cross-attention (to ``ctx``) + FFN
  * ``rwkv``  — RWKV-6 time-mix + channel-mix (attention-free)
  * ``rglru`` — Griffin recurrent block (conv1d + RG-LRU) + FFN
  * ``mla``   — latent attention (``models/mla.py``) + the config's FFN
  * ``mla_dense`` — latent attention + a dense SwiGLU of width ``d_ff``

FFN kinds: ``swiglu`` / ``geglu`` / ``gelu`` / ``moe`` (capacity-factor
dispatch, optional dense residual — Arctic; or, with ``router="sigmoid"``,
drop-free grouped dispatch and shared experts).  Encoder–decoder models add
an encoder stack of bidirectional ``attn`` blocks (seamless).

:class:`ModelConfig` has exactly the JAX package's fields (the parity tests
hold the ten configs to them field for field).  :class:`ExtendedConfig`
adds the fields of architectures the JAX package does not define
(Moonlight-16B-A3B's latent attention, shared experts, sigmoid router and
leading dense layer); on a plain :class:`ModelConfig` the same names read as
class attributes with the values that switch them off.

``ExecConfig`` keeps the knobs the port reads.  The kernel option is
``attn_impl="cuda"`` (the JAX package's ``"pallas"``); ``interpret=True``
runs the kernels' plain versions on CPU tensors; ``attn_impl="flashcost"``
is the dry run's cost surrogate of the flash kernel (never a numerics
path, see ``attention._sdpa_flashcost``).  ``remat`` checkpoints each block
of the trainable model (``"full"``: recompute it all in the backward pass;
``"dots"``: keep the outputs of the products without batch dims, recompute
the rest), and ``logits_chunk`` is the vocab chunk of the loss that the
launchers and the dry run hand to ``train.make_train_step`` (0: the full
loss).  ``scan_layers``, ``scan_unroll`` and ``rec_unroll`` steer XLA's
``lax.scan`` and have no PyTorch form (the port runs its layers and chunks
in Python loops).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ExtendedConfig", "ExecConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    group: Tuple[str, ...] = ("attn",)
    n_groups: int = 0  # 0 -> n_layers // len(group)
    tail: Tuple[str, ...] = ()
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    ffn: str = "swiglu"  # swiglu | geglu | gelu | moe
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    window: int = 0  # local attention window (0 = global)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25  # PATSMA-tunable
    # --- recurrence (rglru) ---
    d_rnn: int = 0  # 0 -> d_model
    conv_width: int = 4
    # --- encoder-decoder / cross-attention context ---
    enc_layers: int = 0  # >0 -> encoder-decoder (seamless)
    ctx_tokens: int = 0  # default context length (vlm image tokens / enc frames)
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256

    # --- ExtendedConfig's fields, off (class attributes, not fields) ---
    lead = ()  # blocks before the repeating group
    norm_eps = 1e-6
    kv_lora_rank = 0  # > 0: latent attention (MLA)
    qk_rope_dim = 0
    n_shared_experts = 0
    router = "softmax"
    routed_scale = 1.0

    # ------------------------------------------------------------- derived
    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_groups == 0 and self.group:
            ng, rem = divmod(self.n_layers - len(self.lead) - len(self.tail), len(self.group))
            if rem:
                raise ValueError(
                    f"{self.name}: n_layers={self.n_layers} does not tile as "
                    f"{self.lead} + {self.group} * n + {self.tail}"
                )
            object.__setattr__(self, "n_groups", ng)
        expect = len(self.lead) + len(self.group) * self.n_groups + len(self.tail)
        if expect != self.n_layers:
            raise ValueError(f"{self.name}: pattern covers {expect} != {self.n_layers} layers")

    @property
    def drop_free(self) -> bool:
        """Whether the MoE dispatch is drop-free at every size (assignments
        sorted by expert, grouped products): the sigmoid router's, where the
        softmax router's drops above ``moe.DROP_FREE_ASSIGNMENTS``."""
        return self.router == "sigmoid"

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.lead + self.group * self.n_groups + self.tail

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def uses_cross_attn(self) -> bool:
        return "cross" in self.pattern

    @property
    def attention_free(self) -> bool:
        return all(k in ("rwkv",) for k in self.pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no *global* attention layer exists (long-context capable)."""
        has_global_attn = any(
            k in ("attn", "cross", "mla", "mla_dense") for k in self.pattern
        ) and self.window == 0
        return not has_global_attn

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, hd = self.d_model, self.d_head
        qkv_out = (self.n_heads + 2 * self.n_kv_heads) * hd
        attn = d * qkv_out + self.n_heads * hd * d
        if self.qkv_bias:
            attn += qkv_out
        ffn = {
            "swiglu": 3 * d * self.d_ff,
            "geglu": 3 * d * self.d_ff,
            "gelu": 2 * d * self.d_ff,
        }.get(self.ffn)
        if self.ffn == "moe":
            ffn = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            if self.moe_dense_residual:
                ffn += 3 * d * self.d_ff
        dr = self.rnn_width
        rglru = 2 * d * dr + dr * d + self.conv_width * dr + 3 * dr + dr * dr // 8
        glu_ffn = 3 * d * self.d_ff
        rwkv_tm = 4 * d * d + d * (64 * 2) + d * (5 * 32) * 2 + 6 * d + d * d
        rwkv_cm = 2 * d * self.d_ff + d * d
        per_kind = {
            "attn": attn + (ffn or 0),
            "cross": attn + attn + (ffn or 0),
            "rwkv": rwkv_tm + rwkv_cm,
            "rglru": rglru + glu_ffn,
        }
        total = sum(per_kind[k] for k in self.pattern)
        if self.enc_layers:
            total += self.enc_layers * (attn + (ffn or 0))
        total += self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts) for 6·N_active·D."""
        if self.ffn != "moe":
            return self.param_count()
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff_expert
        moe_active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff_expert
        return int(full - moe_total + moe_active)


@dataclasses.dataclass(frozen=True)
class ExtendedConfig(ModelConfig):
    """A :class:`ModelConfig` with the fields of architectures the JAX
    package does not define; every default switches its feature off.

    * ``lead``: blocks before the repeating group (``pattern`` = lead +
      group * n_groups + tail): Moonlight's one ``mla_dense`` layer.
    * ``norm_eps``: every RMSNorm's epsilon (the JAX package's 1e-6).
    * latent attention (``mla`` blocks): ``kv_lora_rank`` is the width of
      the latent every head's keys and values come from, ``qk_rope_dim``
      the rotary part of a query/key head, one rope key shared by all
      heads; ``d_head`` is both the non-rotary query/key width and the
      value width.
    * MoE with ``router="sigmoid"``: sigmoid scores, a per-expert bias that
      only selects, gates renormalised and scaled by ``routed_scale``,
      drop-free grouped dispatch, and ``n_shared_experts`` SwiGLU experts
      of width ``d_ff_expert`` that every token runs (one SwiGLU of their
      summed width).
    """

    lead: Tuple[str, ...] = ModelConfig.lead
    norm_eps: float = ModelConfig.norm_eps
    kv_lora_rank: int = ModelConfig.kv_lora_rank
    qk_rope_dim: int = ModelConfig.qk_rope_dim
    n_shared_experts: int = ModelConfig.n_shared_experts
    router: str = ModelConfig.router  # softmax (capacity-factor dispatch) | sigmoid (drop-free)
    routed_scale: float = ModelConfig.routed_scale

    def __post_init__(self):
        super().__post_init__()
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"router must be 'softmax' or 'sigmoid', got {self.router!r}")

    def _mla_params(self) -> int:
        """One latent attention's weights: q (d -> heads x (d_head +
        rope)), the latent and rope key (d -> rank + rope), the latent's
        up-projection to every head's key and value, the output (norms are
        not counted, as in :meth:`ModelConfig.param_count`)."""
        d, H, hd, r, rope = (self.d_model, self.n_heads, self.d_head, self.kv_lora_rank,
                             self.qk_rope_dim)
        return d * H * (hd + rope) + d * (r + rope) + r * H * 2 * hd + H * hd * d

    def _moe_params(self) -> int:
        """One MoE FFN's weights: routed experts, router (and its bias),
        shared experts."""
        d, f = self.d_model, self.d_ff_expert
        n = self.n_experts * 3 * d * f + d * self.n_experts
        if self.router == "sigmoid":
            n += self.n_experts
        return n + 3 * d * f * self.n_shared_experts

    def param_count(self) -> int:
        if not self.kv_lora_rank:
            return super().param_count()
        per_kind = {"mla": self._mla_params() + (self._moe_params() if self.ffn == "moe"
                                                 else 3 * self.d_model * self.d_ff),
                    "mla_dense": self._mla_params() + 3 * self.d_model * self.d_ff}
        total = sum(per_kind[k] for k in self.pattern)
        total += self.padded_vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        if not self.kv_lora_rank or self.ffn != "moe":
            return super().active_param_count()
        moe_layers = sum(k == "mla" for k in self.pattern)
        idle = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
        return int(self.param_count() - moe_layers * idle)


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution-time knobs (model-agnostic)."""

    attn_impl: str = "xla"  # xla (plain PyTorch) | cuda (hand-written kernels) | flashcost
    remat: str = "none"  # none | full | dots  (activation checkpointing, training only)
    logits_chunk: int = 0  # 0 = unchunked loss; else vocab-chunked CE
    rec_chunk: int = 128  # linear-recurrence chunk length (rwkv/rglru)
    block_q: int = 128  # flash attention tiles
    block_kv: int = 128
    interpret: bool = False  # run the kernels' plain versions on CPU tensors

    def __post_init__(self):
        if self.attn_impl not in ("xla", "cuda", "flashcost"):
            raise ValueError(f"attn_impl must be 'xla', 'cuda' or 'flashcost', "
                             f"got {self.attn_impl!r}")
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {self.remat!r}")
