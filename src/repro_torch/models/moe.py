"""Mixture-of-Experts FFN: top-k routing, capacity-factor scatter dispatch.

Port of the JAX package's ``models/moe.py``.  Tokens are scattered into an
(E, C, D) buffer (not the (T, E, C) one-hot einsum), the experts' SwiGLU
runs batched over E, and the outputs are gathered back and summed with the
renormalised gates.  Assignments beyond an expert's capacity ``C`` are
dropped; ``capacity_factor`` is a PATSMA-tunable.  Decode and other small
batches (T·K <= 8192) run drop-free with C = T·K.

Everything is shape-static: C comes from the shapes on the host, and the
dispatch has no ``nonzero``, boolean indexing or host read, so a decode
step with an MoE FFN can be captured as a CUDA graph.  Dropped assignments
all land on slot C - 1 with zero contributions, so the scatter accumulates
(``index_add_``): adding zeros is exact in any order, and a kept token
that shares the slot keeps its value.

Arctic variant (``moe_dense_residual``): a dense SwiGLU FFN runs in parallel
with the MoE and the outputs add.  The Switch load-balance aux loss is
returned for training.  The dispatch buffer carries the JAX package's
expert-parallel constraint (``("ep", "dp", None)``), a no-op outside a
sharding context (:mod:`repro_torch.parallel.api`).

Sigmoid variant (``cfg.router == "sigmoid"``, Moonlight-16B-A3B's, which
the JAX package does not define; it dispatches drop-free, ``cfg.drop_free``; :func:`route_sigmoid`,
:func:`grouped_experts`): fp32 sigmoid scores, the top ``K`` of scores plus
a per-expert bias (``router_bias``, used for selection only; ties go to the
lower expert index), the chosen scores renormalised and scaled by
``routed_scale`` as gates.  Nothing is dropped at any size: the T·K
assignments are sorted by expert (a stable sort, on the device) and each
expert's SwiGLU runs as three grouped products over its contiguous run of
rows (``torch._grouped_mm`` with the runs' ends as offsets), with no
padding, no per-expert loop and no host read of the loads, so a decode
step captures as a CUDA graph.  The outputs go back to token order by a
gather and are summed over the K choices in a fixed order; ``shared``, one
SwiGLU of the shared experts' summed width, adds to every token.  Eager
calls add each layer's per-expert assignment counts on the device to the
registry's ``moe.expert_assignments.<layer>`` (:mod:`repro_torch.obs.metrics`,
read after the run); a call being captured into a graph adds nothing.  The
spans ``moe.route``, ``moe.experts`` and ``moe.combine`` cover its phases.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.obs.metrics import registry
from repro_torch.obs.trace import span
from repro_torch.parallel.api import constrain

from .config import ModelConfig
from .layers import Init, ffn_apply, ffn_init

__all__ = ["moe_init", "moe_apply", "capacity", "route", "route_sigmoid", "grouped_experts",
           "LOAD_COUNTER"]

#: prefix of the registry's per-layer device counters of expert assignments
LOAD_COUNTER = "moe.expert_assignments"

#: token-slot assignments up to which dispatch is drop-free (C = T·K)
DROP_FREE_ASSIGNMENTS = 8192


def moe_init(ini: Init, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {
        "router": ini.nrm((d, e), 1.0 / math.sqrt(d)),
        "wi": ini.nrm((e, d, f), 1.0 / math.sqrt(d)),
        "wg": ini.nrm((e, d, f), 1.0 / math.sqrt(d)),
        "wo": ini.nrm((e, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.moe_dense_residual:
        p["dense"] = ffn_init(ini, "swiglu", d, cfg.d_ff)
    if cfg.router == "sigmoid":
        p["router_bias"] = ini.zeros((e,))
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(ini, "swiglu", d, cfg.n_shared_experts * f)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: ceil(T·K/E·cf), or T·K when
    that is at most :data:`DROP_FREE_ASSIGNMENTS`."""
    assignments = tokens * cfg.top_k
    if assignments <= DROP_FREE_ASSIGNMENTS:
        return assignments
    return int(math.ceil(assignments / cfg.n_experts * cfg.capacity_factor))


def route(cfg: ModelConfig, p: dict, xt: torch.Tensor, C: Optional[int] = None) -> dict:
    """Routing of tokens xt (T, D), in fp32: the renormalised top-k gates
    and experts (T, K), the aux loss, and each assignment's expert, slot
    and whether it is kept (T·K, in token-major, slot-minor order).  ``C``
    is the slots per expert (default ``capacity(cfg, T)``)."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"].float()  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)  # (T,K), descending
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # Switch load-balance aux loss: E * mean(f_e * P_e)
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx, E).float().sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum()

    C = capacity(cfg, T) if C is None else C
    flat_e = eidx.reshape(T * K)
    # running count per expert along the assignments, scanned expert-major
    # (E, T·K): a scan along the inner dim, where a (T·K, E) scan along the
    # outer dim runs one thread per expert column on the card
    pos = torch.cumsum(F.one_hot(flat_e, E).T.contiguous(), dim=1) - 1
    pos_in_e = pos.gather(0, flat_e[None, :])[0]
    keep = pos_in_e < C
    return {"gate": gate, "aux": aux, "capacity": C, "expert": flat_e, "keep": keep,
            "slot": torch.clamp(pos_in_e, max=C - 1)}


def route_sigmoid(cfg: ModelConfig, p: dict, xt: torch.Tensor) -> dict:
    """Sigmoid routing of tokens xt (T, D) in fp32: each token's ``K``
    experts (T, K), the top of ``sigmoid(x W_r) + router_bias`` in
    descending order with ties to the lower expert index (a stable sort),
    and their gates (T, K): the chosen sigmoid scores (not the biased
    ones) over their sum, times ``routed_scale``."""
    K = cfg.top_k
    scores = torch.sigmoid(xt.float() @ p["router"].float())  # (T, E)
    biased = scores + p["router_bias"].float()
    eidx = torch.sort(biased, dim=-1, descending=True, stable=True).indices[:, :K]
    gate = scores.gather(1, eidx)
    gate = gate / gate.sum(dim=-1, keepdim=True) * cfg.routed_scale
    return {"expert": eidx, "gate": gate}


def grouped_experts(p: dict, xt: torch.Tensor, expert: torch.Tensor, n_experts: int,
                    layer: int = -1) -> torch.Tensor:
    """Every assignment's expert SwiGLU, drop-free: xt (T, D), expert (T,
    K) -> (T, K, D) in xt's dtype, row (t, k) the output of expert
    ``expert[t, k]`` for token t.  Sorted by expert, grouped products over
    the contiguous runs, gathered back to assignment order."""
    T, K = expert.shape
    dt = xt.dtype
    flat = expert.reshape(T * K)
    order = torch.sort(flat, stable=True).indices  # assignments grouped by expert
    counts = torch.zeros(n_experts, dtype=torch.int64, device=xt.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    _count(layer, counts)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xs = xt[order // K]  # (T·K, D), sorted by expert
    h = F.silu(torch._grouped_mm(xs, p["wg"].to(dt), offs=offs))
    h = h * torch._grouped_mm(xs, p["wi"].to(dt), offs=offs)
    del xs
    ys = torch._grouped_mm(h, p["wo"].to(dt), offs=offs)
    del h
    where = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=xt.device))
    return ys[where].view(T, K, -1)


def _count(layer: int, counts: torch.Tensor) -> None:
    """Add a layer's per-expert assignments to its device counter (not
    while a graph is being captured)."""
    if layer < 0 or (counts.is_cuda and torch.cuda.is_current_stream_capturing()):
        return
    registry().device_counter(f"{LOAD_COUNTER}.{layer}").add(counts)


def _moe_grouped(cfg: ModelConfig, p: dict, x: torch.Tensor, layer: int):
    """x (B, S, D) -> y (B, S, D) in x's dtype: the sigmoid router, the
    drop-free grouped experts and the shared experts."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    with span("moe.route", "model"):
        r = route_sigmoid(cfg, p, xt)
    with span("moe.experts", "model"):
        ys = grouped_experts(p, xt, r["expert"], cfg.n_experts, layer)
        shared = ffn_apply("swiglu", p["shared"], xt) if cfg.n_shared_experts else None
    with span("moe.combine", "model"):
        # the gates' sum over K, each token a (1, K) x (K, D) product
        y = torch.bmm(r["gate"].to(x.dtype)[:, None], ys)[:, 0]
        if shared is not None:
            y = y + shared
    return y.reshape(B, S, D), torch.zeros((), dtype=torch.float32, device=x.device)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, layer: int = -1):
    """x: (B, S, D) -> (y, aux_loss).  ``layer`` (the block's index in the
    model, -1 for none) names the drop-free dispatch's load counter."""
    if cfg.drop_free:
        return _moe_grouped(cfg, p, x, layer)
    if isinstance(x, DTensor):
        return _moe_sharded(cfg, p, x)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)
    r = route(cfg, p, xt)
    C, keep = r["capacity"], r["keep"]
    flat = r["expert"] * C + r["slot"]  # row of (E·C, D)

    # dispatch: scatter tokens into (E, C, D)
    xr = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    contrib = torch.where(keep[:, None], xr, torch.zeros((), dtype=dt, device=x.device))
    buf = torch.zeros(E * C, D, dtype=dt, device=x.device).index_add_(0, flat, contrib)
    buf = constrain(buf.view(E, C, D), ("ep", "dp", None))  # EP: experts over model axis

    # expert FFN (SwiGLU), batched over E
    h = F.silu(torch.bmm(buf, p["wg"].to(dt))) * torch.bmm(buf, p["wi"].to(dt))
    out = torch.bmm(h, p["wo"].to(dt)).view(E * C, D)

    # combine: gather back + weighted sum over K
    yr = out[flat] * (r["gate"].reshape(T * K, 1).to(dt) * keep[:, None].to(dt))
    y = yr.view(T, K, D).sum(dim=1)

    if cfg.moe_dense_residual:
        y = y + ffn_apply("swiglu", p["dense"], xt)
    return y.reshape(B, S, D), r["aux"]


def _moe_sharded(cfg: ModelConfig, p: dict, x):
    """``moe_apply`` on DTensors (the dry run's), as GShard partitions it:
    each data shard routes its own tokens (its group, with its share of
    the whole batch's capacity, the slots of the global buffer it holds)
    into a local (E, C, D) buffer; the buffer, replicated
    over the model axis, is cut by experts there (no collective), the
    experts' products run where their weights live (their FSDP dim
    gathered), and an all-gather over the model axis brings every expert's
    output back for the combine."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.api import einsum

    mesh = x.device_mesh
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate() for pl in x.placements]
    batch_dims = [i for i, pl in enumerate(rows) if isinstance(pl, Shard)]
    xl = x.redistribute(mesh, rows).to_local()
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in batch_dims else Replicate() for i in range(mesh.ndim)])
    Bl = xl.shape[0]
    T = Bl * S
    xt = xl.reshape(T, D)
    r = route(cfg, {"router": router}, xt, C=max(1, capacity(cfg, B * S) * Bl // B))
    C, keep = r["capacity"], r["keep"]
    flat = r["expert"] * C + r["slot"]
    xr = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    contrib = torch.where(keep[:, None], xr, torch.zeros((), dtype=dt, device=xt.device))
    buf = torch.zeros(E * C, D, dtype=dt, device=xt.device).index_add_(0, flat, contrib)
    cap = [Shard(1) if i in batch_dims else Replicate() for i in range(mesh.ndim)]
    buf = DTensor.from_local(buf.view(E, C, D), mesh, cap, run_check=False)
    buf = constrain(buf, ("ep", "dp", None))  # EP: experts over model axis
    h = F.silu(einsum("ecd,edf->ecf", buf, p["wg"].to(dt))) * einsum("ecd,edf->ecf", buf,
                                                                       p["wi"].to(dt))
    out = einsum("ecf,efd->ecd", h, p["wo"].to(dt))
    out = out.redistribute(mesh, cap).to_local().reshape(E * C, D)
    yr = out[flat] * (r["gate"].reshape(T * K, 1).to(dt) * keep[:, None].to(dt))
    y = DTensor.from_local(yr.view(T, K, D).sum(dim=1).reshape(Bl, S, D), mesh, rows,
                           run_check=False)
    aux = DTensor.from_local(r["aux"], mesh, [Partial("avg") if i in batch_dims else Replicate()
                                              for i in range(mesh.ndim)], run_check=False)
    aux = aux.redistribute(mesh, [Replicate()] * mesh.ndim)
    if cfg.moe_dense_residual:
        y = y + ffn_apply("swiglu", p["dense"], x)
    return y, aux
