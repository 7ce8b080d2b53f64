"""Model: embeddings → block stack → LM head, as an ``nn.Module``.

Port of the JAX package's ``models/model.py`` for decoder-only models made
of ``attn``, ``rglru`` and ``rwkv`` blocks.  Where the JAX package stacks
each repeating group's parameters and runs the group under ``lax.scan``,
the port keeps one block per layer in an ``nn.ModuleList`` in pattern order
(``cfg.pattern``); :func:`repro_torch.models.convert.params_from_jax`
unstacks JAX parameters into that order.  The encoder and the VLM context
wait for a later slice and raise ``NotImplementedError``.

Weights.  The JAX model keeps fp32 parameters and casts most of them to the
compute dtype at each use.  The port stores exactly those weights in the
compute dtype (the rounding is the one the cast makes, so the numbers are
the same, and a decode step does not re-read fp32 copies) and keeps the
rest in fp32: the norms, the RG-LRU gates (``wa``, ``ba``, ``wi``, ``bi``,
``lam``) and the RWKV decay and bonus (``w0``, ``w1``, ``w2``, ``u``).
Parameters are drawn from an explicit ``torch.Generator`` on the model's
device, which is the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn

from .blocks import apply_block, init_block, init_block_state
from .config import ExecConfig, ModelConfig
from .layers import Init, embed_init, norm_apply, norm_init

__all__ = ["Model", "ParamTree", "keeps_fp32"]

_NORMS = ("norm1", "norm2", "ln1", "ln2", "final_norm")
_FP32_AT_USE = {"rec": ("wa", "ba", "wi", "bi", "lam"), "tm": ("w0", "w1", "w2", "u")}


def keeps_fp32(path: Tuple[str, ...]) -> bool:
    """Whether the JAX model uses the parameter at ``path`` in fp32 (so the
    port stores it in fp32); every other weight is cast at use."""
    parent, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    return parent in _NORMS or leaf in _FP32_AT_USE.get(parent, ())


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: sub-dicts become child modules,
    tensors frozen parameters, so ``state_dict`` keys are the dotted paths
    (``rec.wa``, ``tm.ln_x.scale``)."""

    def __init__(self, tree: dict, compute_dtype: torch.dtype, path: Tuple[str, ...] = ()):
        super().__init__()
        for name, val in tree.items():
            sub = path + (name,)
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val, compute_dtype, sub))
            else:
                dt = torch.float32 if keeps_fp32(sub) else compute_dtype
                self.register_parameter(name, nn.Parameter(val.to(dt), requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of parameters, as the apply functions take it."""
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, exec_cfg: ExecConfig = ExecConfig(), *,
                 device="cuda", seed: int = 0):
        super().__init__()
        if cfg.is_encdec or cfg.family == "vlm":
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder and VLM models wait for a later slice of the port"
            )
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.device = torch.device(device)
        dt = getattr(torch, cfg.compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ini = Init(gen, self.device)
        self.embedding = ParamTree({"table": embed_init(ini, cfg.padded_vocab, cfg.d_model)["table"]}, dt)
        self.layers = nn.ModuleList(
            ParamTree(init_block(ini, kind, cfg), dt) for kind in cfg.pattern
        )
        self.final_norm = ParamTree(norm_init(ini, cfg.norm, cfg.d_model), dt, ("final_norm",))
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree({"w": ini.nrm((cfg.d_model, cfg.padded_vocab),
                                                   cfg.d_model ** -0.5)}, dt)

    # ------------------------------------------------------------- plumbing
    def _layer_trees(self) -> list:
        return [layer.tree() for layer in self.layers]

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _run_stack(self, x, states, *, q_pos, causal):
        new_states = []
        for kind, p, st in zip(self.cfg.pattern, self._layer_trees(), states):
            x, st = apply_block(kind, self.cfg, p, x, st, q_pos=q_pos, causal=causal,
                                exec_cfg=self.exec_cfg)
            new_states.append(st)
        return x, new_states

    def init_states(self, batch: int, max_len: int, mode: str) -> list:
        """Per-layer states in pattern order ({} for stateless attention)."""
        return [
            init_block_state(kind, self.cfg, batch, max_len, mode, window=self.cfg.window,
                             device=self.device)
            for kind in self.cfg.pattern
        ]

    # ------------------------------------------------------------ embeddings
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # the rows, then the cast: the same values as casting the table first
        return self.embedding.table[tokens].to(self.compute_dtype)

    def head_weights(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embedding.table.T
        return self.lm_head.w

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.head_weights().to(x.dtype)

    # ----------------------------------------------------------------- modes
    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Teacher-forced full-sequence pass.  batch["tokens"]: (B,S).
        Returns the final-normed hidden states (B,S,D); logits via
        :meth:`logits`."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self.embed(tokens)
        states = self.init_states(B, S, mode="train")
        x, _ = self._run_stack(x, states, q_pos=torch.arange(S, device=self.device), causal=True)
        return norm_apply(self.cfg.norm, self.final_norm.tree(), x)

    @torch.no_grad()
    def prefill(self, batch: dict) -> Tuple[torch.Tensor, list]:
        """Run the prompt, build caches.  Returns (last-token hidden (B,D), states)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = batch.get("max_len", S)
        x = self.embed(tokens)
        states = self.init_states(B, max_len, mode="prefill")
        x, states = self._run_stack(x, states, q_pos=torch.arange(S, device=self.device),
                                    causal=True)
        x = norm_apply(self.cfg.norm, self.final_norm.tree(), x[:, -1:])
        return x[:, 0], states

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, states: list,
                    pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, list]:
        """One token for every sequence in the batch.  token: (B,1) int64;
        pos: the current absolute position, an int or a 0-d int64 tensor on
        the model's device (read on the device: a CUDA graph can advance it
        in place); both give the same logits.  Returns (logits (B,V),
        states); attention caches are written in place.  Nothing on this
        path reads a tensor back to the host."""
        x = self.embed(token)
        if isinstance(pos, torch.Tensor):
            q_pos = pos.reshape(1)
        else:
            q_pos = torch.arange(pos, pos + 1, device=self.device)
        x, states = self._run_stack(x, states, q_pos=q_pos, causal=True)
        x = norm_apply(self.cfg.norm, self.final_norm.tree(), x)
        return self.logits(x)[:, 0], states
