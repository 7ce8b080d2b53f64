"""Model: embeddings → block stack → LM head, as an ``nn.Module``.

Port of the JAX package's ``models/model.py``: dense and MoE decoders,
RWKV-6, the Griffin hybrid, the seamless encoder–decoder (audio frontend
stubbed as precomputed frame embeddings, ``batch["frames"]``) and the
llama-3.2 vision backbone (patch embeddings stubbed, ``batch["ctx_embeds"]``;
the cross-attention layers are real).  Where the JAX package stacks each
repeating group's parameters and runs the group under ``lax.scan``, the
port keeps one block per layer in an ``nn.ModuleList`` in pattern order
(``cfg.pattern``), and the encoder's ``enc_layers`` bidirectional ``attn``
blocks in a second one; :func:`repro_torch.models.convert.params_from_jax`
unstacks JAX parameters into that order.

Weights.  The JAX model keeps fp32 parameters and casts most of them to the
compute dtype at each use.  The port stores exactly those weights in the
compute dtype (the rounding is the one the cast makes, so the numbers are
the same, and a decode step does not re-read fp32 copies) and keeps the
rest in fp32: the norms, the MoE router, the RG-LRU gates (``wa``, ``ba``,
``wi``, ``bi``, ``lam``) and the RWKV decay and bonus (``w0``, ``w1``,
``w2``, ``u``).
Parameters are drawn from an explicit ``torch.Generator`` on the model's
device, which is the card unless the caller asks for the CPU.  On the meta
device (``device="meta"``) they are shapes and dtypes only, with no
generator and no storage: the launch layer's stand-ins
(:mod:`repro_torch.launch.input_specs`) and the sharding of the largest
configs read them.

Training.  :class:`TrainModel` is the trainable form: every weight is an
fp32 master (``cfg.param_dtype``) that requires grad and is cast at use, as
in the JAX model, and ``forward`` builds the autograd graph and returns
``(hidden, aux)`` like the JAX ``Model.forward`` (aux: the MoE layers'
summed router loss, 0 without them).  ``ExecConfig.remat`` checkpoints each
block of it (``torch.utils.checkpoint``, non-reentrant), where the JAX model
checkpoints the scanned group body: ``"full"`` recomputes the whole block in
the backward pass, ``"dots"`` keeps the Linear layers' outputs.  Serving
(under ``no_grad``) never checkpoints.
The same seed draws the same numbers in both forms; the serving form keeps
the cast of them.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.parallel.api import (constrain, current_rules, matmul, mesh_axes,
                                      shard_index)
from repro_torch.parallel.sharding import state_wanted, tree_distribute

from .blocks import apply_block, init_block, init_block_state
from .config import ExecConfig, ModelConfig
from .layers import Init, embed_init, norm_apply, norm_init

__all__ = ["Model", "TrainModel", "ParamTree", "keeps_fp32"]

_NORMS = ("norm1", "norm2", "normx", "ln1", "ln2", "final_norm", "encoder_norm", "kv_norm")
_FP32_AT_USE = {"rec": ("wa", "ba", "wi", "bi", "lam"), "tm": ("w0", "w1", "w2", "u"),
                "ffn": ("router", "router_bias")}

#: products without batch dims: the Linear layers (``x @ w`` lowers to
#: ``mm``); the attention einsums (``bmm``) have a batch dim
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    products without batch dims, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


#: ``ExecConfig.remat`` -> the ``context_fn`` of ``torch.utils.checkpoint``
_REMAT_CONTEXT = {
    "full": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts, _dots_policy),
}


def keeps_fp32(path: Tuple[str, ...]) -> bool:
    """Whether the JAX model uses the parameter at ``path`` in fp32 (so the
    port stores it in fp32); every other weight is cast at use."""
    parent, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    return parent in _NORMS or leaf in _FP32_AT_USE.get(parent, ())


def _embed_sharded(table, tokens):
    """The rows of a DTensor table (vocab over the model axis, the model
    dim over data) for ``tokens``, as GSPMD partitions a vocab-parallel
    lookup: the table's model dim is gathered, each rank looks its tokens
    up in its slice of the vocabulary (zero rows for tokens it does not
    hold), and an all-reduce adds the slices."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    on_v = [i for i, pl in enumerate(table.placements) if isinstance(pl, Shard) and pl.dim == 0]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    rows = [Replicate() if i in on_v else pl for i, pl in enumerate(tokens.placements)]
    tok = tokens.redistribute(mesh, rows).to_local()
    grads = [Shard(0) if i in on_v else Partial() if isinstance(rows[i], Shard) else Replicate()
             for i in range(mesh.ndim)]
    tab = table.redistribute(mesh, [Shard(0) if i in on_v else Replicate()
                                    for i in range(mesh.ndim)]).to_local(grad_placements=grads)
    shard = shard_index(mesh, on_v)
    idx = tok - shard * tab.shape[0]
    mine = (idx >= 0) & (idx < tab.shape[0])
    part = F.embedding(idx.clamp(0, tab.shape[0] - 1), tab) * mine[..., None].to(tab.dtype)
    out = DTensor.from_local(part, mesh, [Partial() if i in on_v else pl for i, pl in enumerate(rows)],
                             run_check=False)
    return out.redistribute(mesh, rows)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: sub-dicts become child modules,
    tensors parameters, so ``state_dict`` keys are the dotted paths
    (``rec.wa``, ``tm.ln_x.scale``).  Without ``master`` the parameters are
    frozen in the dtype they are used in (serving); with it, every one is a
    trainable master in that dtype."""

    def __init__(self, tree: dict, compute_dtype: torch.dtype, path: Tuple[str, ...] = (),
                 master: Optional[torch.dtype] = None):
        super().__init__()
        for name, val in tree.items():
            sub = path + (name,)
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val, compute_dtype, sub, master))
            elif master is not None:
                self.register_parameter(name, nn.Parameter(val.to(master)))
            else:
                dt = torch.float32 if keeps_fp32(sub) else compute_dtype
                self.register_parameter(name, nn.Parameter(val.to(dt), requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of parameters, as the apply functions take it."""
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


class Model(nn.Module):
    #: store fp32 masters that require grad (:class:`TrainModel`)
    trainable = False

    def __init__(self, cfg: ModelConfig, exec_cfg: ExecConfig = ExecConfig(), *,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.device = torch.device(device)
        dt = getattr(torch, cfg.compute_dtype)
        gen = (None if self.device.type == "meta"
               else torch.Generator(device=self.device).manual_seed(seed))
        ini = Init(gen, self.device)
        m = getattr(torch, cfg.param_dtype) if self.trainable else None
        self.embedding = ParamTree({"table": embed_init(ini, cfg.padded_vocab, cfg.d_model)["table"]},
                                   dt, master=m)
        self.layers = nn.ModuleList(
            ParamTree(init_block(ini, kind, cfg), dt, master=m) for kind in cfg.pattern
        )
        self.final_norm = ParamTree(norm_init(ini, cfg.norm, cfg.d_model), dt, ("final_norm",), m)
        if not cfg.tie_embeddings:
            self.lm_head = ParamTree({"w": ini.nrm((cfg.d_model, cfg.padded_vocab),
                                                   cfg.d_model ** -0.5)}, dt, master=m)
        if cfg.is_encdec:  # same dims; bidirectional attn blocks
            self.encoder = nn.ModuleList(
                ParamTree(init_block(ini, "attn", cfg), dt, master=m) for _ in range(cfg.enc_layers)
            )
            self.encoder_norm = ParamTree(norm_init(ini, cfg.norm, cfg.d_model), dt,
                                          ("encoder_norm",), m)

    # ------------------------------------------------------------- plumbing
    def _layer_trees(self) -> list:
        return [layer.tree() for layer in self.layers]

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _run_stack(self, kinds, layers, x, states, *, q_pos, ctx, mode, causal):
        """Blocks ``kinds`` with parameters ``layers`` in turn; returns (x,
        new states, the summed aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        new_states = []
        remat = self.exec_cfg.remat if self.trainable and torch.is_grad_enabled() else "none"
        for i, (kind, layer, st) in enumerate(zip(kinds, layers, states)):
            x = constrain(x, ("dp", "sp", None))  # a no-op outside a sharding context
            block = functools.partial(apply_block, kind, self.cfg, layer.tree(), q_pos=q_pos,
                                      ctx=ctx, mode=mode, causal=causal, exec_cfg=self.exec_cfg,
                                      layer=i)
            if remat == "none":
                x, st, a = block(x, st)
            else:
                x, st, a = checkpoint(block, x, st, use_reentrant=False,
                                      context_fn=_REMAT_CONTEXT[remat])
            new_states.append(st)
            if a is not None:
                aux = aux + a
        return x, new_states, aux

    def _init_states_for(self, kinds, batch: int, max_len: int, mode: str) -> list:
        states = [
            init_block_state(kind, self.cfg, batch, max_len, mode, window=self.cfg.window,
                             device=self.device)
            for kind in kinds
        ]
        return self._place_states(states)

    def _place_states(self, states: list) -> list:
        """Inside a sharding context, on a model whose parameters are
        DTensors (the dry run's), the states as DTensors placed by the
        sharding rules (``state_wanted``); elsewhere unchanged."""
        ctx = current_rules()
        if ctx is None or not isinstance(self.embedding.table, DTensor):
            return states
        mesh, rules = ctx
        tp = mesh_axes(mesh).get("model", 0)
        return tree_distribute(mesh, rules, states,
                               lambda path, shape: state_wanted(path, shape, tp_size=tp))

    def init_states(self, batch: int, max_len: int, mode: str) -> list:
        """Per-layer states in pattern order ({} for stateless attention)."""
        return self._init_states_for(self.cfg.pattern, batch, max_len, mode)

    # ------------------------------------------------------------ embeddings
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # the rows, then the cast: the same values as casting the table first
        table = self.embedding.table
        if isinstance(table, DTensor):  # the dry run's
            return _embed_sharded(table, tokens).to(self.compute_dtype)
        return table[tokens].to(self.compute_dtype)

    def head_weights(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embedding.table.T
        return self.lm_head.w

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return matmul(x, self.head_weights().to(x.dtype))

    # --------------------------------------------------------------- encoder
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, D) precomputed embeddings (modality stub).
        Bidirectional attention over the whole sequence: under
        ``attn_impl="cuda"`` every layer runs the flash kernel, non-causal."""
        B, S = frames.shape[:2]
        kinds = ("attn",) * self.cfg.enc_layers
        x = frames.to(self.compute_dtype)
        states = self._init_states_for(kinds, B, S, mode="train")
        x, _, _ = self._run_stack(kinds, self.encoder, x, states,
                                  q_pos=torch.arange(S, device=self.device), ctx=None,
                                  mode="train", causal=False)
        return norm_apply(self.cfg.norm, self.encoder_norm.tree(), x)

    def _context(self, batch: dict) -> Optional[torch.Tensor]:
        if self.cfg.is_encdec:
            return self.encode(batch["frames"])
        if self.cfg.family == "vlm":
            return batch["ctx_embeds"].to(self.compute_dtype)
        return None

    # ----------------------------------------------------------------- modes
    def _forward(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = batch["tokens"]
        B, S = tokens.shape
        ctx = self._context(batch)
        x = self.embed(tokens)
        states = self.init_states(B, S, mode="train")
        x, _, aux = self._run_stack(self.cfg.pattern, self.layers, x, states,
                                    q_pos=torch.arange(S, device=self.device), ctx=ctx,
                                    mode="train", causal=True)
        return norm_apply(self.cfg.norm, self.final_norm.tree(), x, self.cfg.norm_eps), aux

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Teacher-forced full-sequence pass.  batch["tokens"]: (B,S), plus
        ``frames`` (encoder–decoder) or ``ctx_embeds`` (VLM).  Returns the
        final-normed hidden states (B,S,D); logits via :meth:`logits`."""
        return self._forward(batch)[0]

    @torch.no_grad()
    def prefill(self, batch: dict) -> Tuple[torch.Tensor, list]:
        """Run the prompt, build caches.  Returns (last-token hidden (B,D), states)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = batch.get("max_len", S)
        ctx = self._context(batch)
        x = self.embed(tokens)
        states = self.init_states(B, max_len, mode="prefill")
        x, states, _ = self._run_stack(self.cfg.pattern, self.layers, x, states,
                                       q_pos=torch.arange(S, device=self.device), ctx=ctx,
                                       mode="prefill", causal=True)
        x = norm_apply(self.cfg.norm, self.final_norm.tree(), x[:, -1:], self.cfg.norm_eps)
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
        x, states, _ = self._run_stack(self.cfg.pattern, self.layers, x, states, q_pos=q_pos,
                                       ctx=None, mode="decode", causal=True)
        x = norm_apply(self.cfg.norm, self.final_norm.tree(), x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], states


class TrainModel(Model):
    """The trainable form of :class:`Model`: fp32 masters (``cfg.param_dtype``)
    that require grad, cast to the compute dtype at each use.  ``prefill``
    and ``decode_step`` work as in the serving form (under ``no_grad``)."""

    trainable = True

    def params(self) -> dict:
        """The parameters by dotted name: the ``params`` of the train step,
        the optimizer and the checkpoint (the live tensors, updated in place)."""
        return dict(self.named_parameters())

    def forward(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced full-sequence pass that builds the autograd graph.
        batch["tokens"]: (B,S) (plus the context inputs).  Returns (hidden
        (B,S,D), aux loss) like the JAX ``Model.forward``: aux is the MoE
        layers' summed router loss, a 0-d fp32 tensor (0 without them)."""
        return self._forward(batch)
