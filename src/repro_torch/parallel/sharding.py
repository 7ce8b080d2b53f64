"""Parameter / batch / cache sharding rules (DP + FSDP/ZeRO-3 + TP + EP).

Counterpart of the JAX package's ``parallel/sharding.py``, with its regexes
in their order.  ``param_wanted(path, shape)`` returns logical axes per dim
(see api.py); ``tree_shardings`` turns a tree of named tensors (real, meta
or fake) into DTensor placements on a ``DeviceMesh``, with divisibility
guards (heads that don't divide the model axis replicate — e.g. qwen2's 28
heads on a 16-way axis shard via the fused H*hd dim of the projection
instead).

Names.  The port's parameters are dotted and one per layer
(``layers.3.attn.wq.w``, ``encoder.5.attn.wo.w``, ``embedding.table``);
the JAX package's are slash paths with each repeating group stacked on a
leading dim (``stages/0/pos1/attn/wq/w``).  :func:`path_str` writes a port
name in the JAX form the regexes read (``layers/3/attn/wq/w``,
``embed/table``, ``encoder/norm/scale``), and since a port leaf has no
stack dim its wanted axes are the JAX leaf's with the stack entry dropped.
The port keeps JAX's ``(in, out)`` weight layout, so no dim moves.  The
decode states are per layer too (``3/kv/k`` of shape (B, Kh, W, hd) where
JAX has ``0/pos0/kv/k`` of shape (ng, B, Kh, W, hd)): :func:`state_wanted`
reads the unstacked shape.
"""
from __future__ import annotations

import re
from typing import Tuple

from .api import ShardingRules, logical_spec, to_placements

__all__ = ["param_wanted", "batch_wanted", "state_wanted", "tree_shardings", "path_str",
           "replicated", "tree_distribute"]

#: the port's top-level module names that the JAX package spells otherwise
_JAX_NAMES = {"embedding": "embed", "encoder_norm": "encoder/norm"}


def path_str(path) -> str:
    """A leaf's path in the JAX package's slash form: ``path`` is a dotted
    port name (``layers.3.attn.wq.w``) or a sequence of keys, each of which
    may be dotted (state paths: ``(3, "kv", "k")``)."""
    keys = [path] if isinstance(path, str) else path
    parts = [part for key in keys for part in str(key).split(".")]
    if parts:
        parts[0] = _JAX_NAMES.get(parts[0], parts[0])
    return "/".join(parts)


def _stacked(path: str) -> bool:
    return path.startswith("stages/") or path.startswith("encoder/stages/")


def _ndim(shape_or_ndim) -> int:
    return shape_or_ndim if isinstance(shape_or_ndim, int) else len(shape_or_ndim)


def param_wanted(path: str, shape) -> Tuple:
    """Logical placement per dim for a parameter leaf."""
    ndim = _ndim(shape)
    base_ndim = ndim - 1 if _stacked(path) else ndim

    def out(*axes):
        axes = tuple(axes) + (None,) * (base_ndim - len(axes))
        return ((None,) + axes) if _stacked(path) else axes

    # --- embeddings / head ---
    if re.search(r"embed/table$", path):
        return out("tp", "fsdp")
    if re.search(r"lm_head/w$", path):
        return out("fsdp", "tp")
    # --- attention ---
    if re.search(r"(attn|xattn)/w[qkv]/w$", path):
        return out("fsdp", "tp")
    if re.search(r"(attn|xattn)/w[qkv]/b$", path):
        return out("tp")
    if re.search(r"(attn|xattn)/wo/w$", path):
        return out("tp", "fsdp")
    # --- MoE experts (E, D, F) / (E, F, D); router (D, E) ---
    if re.search(r"ffn/(wi|wg)$", path) and base_ndim == 3:
        return out("ep", "fsdp", None)
    if re.search(r"ffn/wo$", path) and base_ndim == 3:
        return out("ep", None, "fsdp")
    if re.search(r"ffn/router$", path):
        return out("fsdp", None)
    # --- dense FFN (incl. arctic dense residual under ffn/dense/) ---
    if re.search(r"(ffn|dense|cm)/(wi|wg|wk)$", path) and base_ndim == 2:
        return out("fsdp", "tp")
    if re.search(r"(ffn|dense|cm)/(wo|wv)$", path) and base_ndim == 2:
        return out("tp", "fsdp")
    if re.search(r"ffn/bi$", path):
        return out("tp")
    # --- rwkv time-mix ---
    if re.search(r"tm/(wr|wk|wv|wg)$", path):
        return out("fsdp", "tp")
    if re.search(r"tm/wo$", path):
        return out("tp", "fsdp")
    if re.search(r"(tm/w1|tm/mix_w1|cm/wr)$", path):
        return out("fsdp", None) if "w1" in path else out("fsdp", "tp")
    if re.search(r"tm/w2$", path):
        return out(None, "fsdp")
    # --- rglru ---
    if re.search(r"rec/(wx_gelu|wx_rec|wa|wi)$", path):
        return out("fsdp", "tp")
    if re.search(r"rec/wo$", path):
        return out("tp", "fsdp")
    if re.search(r"rec/conv_w$", path):
        return out(None, "tp")
    if re.search(r"rec/(lam|ba|bi|conv_b)$", path):
        return out("tp")
    # --- everything else (norms, small LoRAs, u, biases): replicated ---
    return out()


def batch_wanted(name: str, shape) -> Tuple:
    ndim = _ndim(shape)
    if name in ("tokens", "labels"):
        return ("dp", "sp")[:ndim] if ndim == 2 else ("dp",) + (None,) * (ndim - 1)
    if name in ("frames", "ctx_embeds"):
        return ("dp", None, None)
    return ("dp",) + (None,) * (ndim - 1)


def state_wanted(path: str, shape, tp_size: int = 0) -> Tuple:
    """Decode caches / recurrent states of one layer (no group-stack dim).

    KV caches prefer head sharding; when the KV head count does not divide
    the model axis (GQA kv=8 on a 16-way axis) the cache's *sequence* dim is
    sharded instead — the sharded-KV / flash-decode layout (the softmax over
    the sharded axis becomes two small all-reduces)."""
    ndim = _ndim(shape)

    def out(*axes):
        return tuple(axes) + (None,) * (ndim - len(axes))

    if re.search(r"/(k|v|xk|xv)$", path):  # (B, Kh, W, hd)
        if (
            tp_size
            and not isinstance(shape, int)
            and shape[1] % tp_size != 0
            and shape[2] % tp_size == 0
        ):
            return out("dp", None, "tp", None)  # sharded-sequence KV
        return out("dp", "tp", None, None)
    if path.endswith("/pos"):  # (W,)
        return out()
    if path.endswith("/wkv"):  # (B, H, hd, hd)
        return out("dp", "tp", None, None)
    if re.search(r"/(shift_tm|shift_cm|h)$", path):  # (B, D)
        return out("dp", "tp")
    if path.endswith("/conv"):  # (B, W-1, dr)
        return out("dp", None, "tp")
    return out()


def _map_leaves(tree, fn, keys=()):
    """``tree`` with every tensor leaf ``x`` at key path ``keys`` replaced by
    ``fn(keys, x)``; dicts and lists keep their structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, keys + (i,)) for i, v in enumerate(tree))
    return fn(keys, tree)


def tree_shardings(mesh, rules: ShardingRules, tree, wanted_fn) -> object:
    """``tree`` (a dict of named tensors, or nested dicts and lists of them)
    with each tensor replaced by its DTensor placements on ``mesh``:
    ``wanted_fn(path_str(path), shape)`` names the logical axes, the rules
    and the divisibility guard of :func:`logical_spec` pick the mesh axes."""

    def leaf(keys, x):
        path = path_str(keys)
        wanted = wanted_fn(path, tuple(x.shape))
        return to_placements(mesh, logical_spec(mesh, rules, x.shape, wanted))

    return _map_leaves(tree, leaf)


def tree_distribute(mesh, rules: ShardingRules, tree, wanted_fn) -> object:
    """``tree`` with each tensor distributed (``distribute_tensor``) to the
    placements :func:`tree_shardings` gives it."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(keys, x):
        wanted = wanted_fn(path_str(keys), tuple(x.shape))
        return distribute_tensor(x, mesh, to_placements(mesh, logical_spec(mesh, rules, x.shape,
                                                                           wanted)))

    return _map_leaves(tree, leaf)


def replicated(mesh, tree):
    from torch.distributed.tensor import Replicate

    return _map_leaves(tree, lambda keys, x: (Replicate(),) * len(mesh.shape))
