"""Dry run: count one step of every (architecture × input shape) cell on
the production mesh, per rank, and hold it against the card's roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out results.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tiny --mesh 4,4 --arch qwen2_7b \\
        --shape train_4k

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on a mesh of host devices and reads XLA's cost and
memory analyses.  PyTorch has no compiler to ask, so the port runs the step
itself with nothing behind it: the parameters, the AdamW state, the batch
and the caches are DTensors on the ``meta`` device (shapes and dtypes, no
storage), placed by the sharding layer (:mod:`repro_torch.parallel.sharding`)
on a mesh over a ``fake`` process group of any size (256 ranks, or 512 with
``--multi-pod``; ``--mesh`` for another shape), and a dispatch mode
(:class:`~repro_torch.core.costs.StepCounter`) counts what rank 0 does:
FLOPs, bytes, collective bytes by kind, and the peak of its live bytes.
Nothing executes on any device, which is the counterpart of the JAX
package's host-platform mesh, not a fallback; the JAX package's device-count
environment code has no counterpart (a fake group has any size).

The roofline is against :data:`~repro_torch.core.costs.H100_SXM` (the data
sheet, not a measurement): compute at the peak for the compute dtype,
memory at the HBM rate, collectives over the card's NVLink links.  The
flash kernel cannot run on meta tensors, so the dry run counts the plain
attention path (``attn_impl="xla"``, the default) or the kernel's cost
surrogate (``"flashcost"``), as the JAX package lowers its XLA path.

Every layer runs in a Python loop and is counted, so the JAX package's
while-body correction has nothing to correct; :func:`cost_by_delta` still
counts 2- and 4-group variants and extrapolates to full depth, because 126
layers of llama3-405b through DTensor dispatch are slow, and the hill climb
(:mod:`repro_torch.launch.hillclimb`) calls it for every candidate.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Optional, Union

import torch
from torch import nn

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.core.costs import H100_SXM, HardwareSpec, RooflineTerms, StepCounter
from repro_torch.launch import costing
from repro_torch.launch.input_specs import prefill_inputs, train_inputs
from repro_torch.launch.mesh import default_rules, fake_process_group, make_mesh
from repro_torch.models import ExecConfig, Model, TrainModel
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.parallel.api import sharding_context
from repro_torch.parallel.sharding import (batch_wanted, param_wanted, path_str,
                                             tree_distribute)
from repro_torch.train import make_train_step

__all__ = ["default_exec", "build_cell_program", "count_cell", "cost_by_delta", "run_cell",
           "main"]

def _opt_wanted(path, shape):
    """AdamW's ``m/<param>`` and ``v/<param>`` like their parameters (the
    parameter's path renamed as ``path_str`` renames a top-level name)."""
    if path.startswith(("m/", "v/")):
        return param_wanted(path_str(path[2:].split("/")), shape)
    return ()


def _batch_wanted(path, shape):
    return batch_wanted(path.split("/")[-1], shape)


def default_exec(cfg, shape_kind: str, overrides: Optional[dict] = None) -> ExecConfig:
    """Baseline execution config (the JAX package's: the plain attention
    path, ``remat="full"`` for training); ``overrides`` sets fields."""
    kw = dict(
        attn_impl="xla",  # the flash kernel cannot run on meta tensors
        remat="full" if shape_kind == "train" else "none",
        logits_chunk=0,
        rec_chunk=128,
    )
    kw.update(overrides or {})
    return ExecConfig(**kw)


def _shape(shape) -> ShapeSpec:
    return configs.SHAPES[shape] if isinstance(shape, str) else shape


def _place_params(model: nn.Module, mesh, rules) -> dict:
    """Replace every parameter of ``model`` by a DTensor placed by
    ``param_wanted``; returns them by dotted name."""
    named = dict(model.named_parameters())
    placed = tree_distribute(mesh, rules, {n: p.detach() for n, p in named.items()},
                             param_wanted)
    for name, p in named.items():
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf,
                nn.Parameter(placed[name], requires_grad=p.requires_grad))
    return dict(model.named_parameters())


@contextlib.contextmanager
def _alltoall_as_alltoall():
    """On a mesh of device type ``cpu`` (a gloo or fake group) DTensor runs
    a shard-dim all-to-all as an all-gather and a chunk, because gloo has no
    all-to-all; NCCL runs the all-to-all.  The fake group moves nothing, so
    here DTensor issues the all-to-all op itself and the counter sees what a
    card would do (MoE's dispatch bytes, not the axis size times them)."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    mods = [m for m in (_collective_utils, placement_types) if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.shard_dim_alltoall = fn


def build_cell_program(cfg, exec_cfg, shape, mesh, rules, *, microbatches: int = 1):
    """(fn, args) of one cell, on the meta device: ``fn(*args)`` runs the
    step of ``shape``'s kind (train: ``make_train_step``; prefill: the
    prompt and the last token's logits; decode: one token), on arguments
    that are DTensors placed by the sharding rules — parameters by
    ``param_wanted``, AdamW's ``m/`` and ``v/`` like their parameters, the
    batch by ``batch_wanted``, decode states by ``state_wanted``.  Call it
    inside ``sharding_context(mesh, rules)``."""
    shape = _shape(shape)
    if shape.kind == "train":
        model = TrainModel(cfg, exec_cfg, device="meta")
        params = _place_params(model, mesh, rules)
        opt = AdamW(lr=3e-4, state_dtype=cfg.param_dtype)
        # the state of the parameters' global shapes, then placed like them
        opt_state = tree_distribute(
            mesh, rules, opt.init({n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                                   for n, p in params.items()}), _opt_wanted)
        batch = tree_distribute(mesh, rules, train_inputs(cfg, shape), _batch_wanted)
        fn = make_train_step(model, opt, microbatches=microbatches,
                             logits_chunk=exec_cfg.logits_chunk)
        return fn, (params, opt_state, batch)
    model = Model(cfg, exec_cfg, device="meta")
    params = _place_params(model, mesh, rules)
    if shape.kind == "prefill":
        def prefill(params, batch):
            hidden, states = model.prefill(batch)
            return model.logits(hidden[:, None])[:, 0], states

        batch = tree_distribute(mesh, rules, prefill_inputs(cfg, shape), _batch_wanted)
        return prefill, (params, batch)

    def decode(params, token, states, pos):
        return model.decode_step(token, states, pos)

    B = shape.global_batch
    token = tree_distribute(mesh, rules, {"token": torch.empty((B, 1), dtype=torch.int64,
                                                               device="meta")},
                            lambda p, sh: ("dp", None))["token"]
    states = model.init_states(B, shape.seq_len, mode="decode")  # placed: a context is active
    pos = torch.zeros((), dtype=torch.int64, device="meta")
    return decode, (params, token, states, pos)


def _local(t):
    return getattr(t, "_local_tensor", t)


def _bytes(tensors) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in tensors)


def count_cell(cfg, exec_cfg, shape, mesh, rules, *, microbatches: int = 1):
    """Count one step of the cell on ``mesh``: (CostTerms, memory dict).
    Memory is rank 0's: ``argument_bytes`` (its shards of the arguments),
    ``output_bytes`` (of the results), ``alias_bytes`` (results that are
    arguments updated in place: the train step's parameters and AdamW
    state, the decode caches), ``peak_bytes`` (the peak of live storages,
    arguments included) and ``temp_bytes`` (the peak less the arguments and
    the results that are not arguments)."""
    with sharding_context(mesh, rules), _alltoall_as_alltoall():
        from torch.distributed.tensor.experimental import implicit_replication

        # implicit replication: the plain tensors the model makes on its
        # device (positions, masks, rope tables) meet DTensors as replicas
        with implicit_replication():
            fn, args = build_cell_program(cfg, exec_cfg, shape, mesh, rules,
                                          microbatches=microbatches)
            arg_leaves = tree_leaves(args)
            counter = StepCounter(device="meta")
            counter.hold(arg_leaves)
            with counter:
                out = fn(*args)
            out_leaves = tree_leaves(out)
    arg_storages = {id(_local(t).untyped_storage()) for t in arg_leaves}
    alias = [t for t in out_leaves if id(_local(t).untyped_storage()) in arg_storages]
    argument, output, alias_b = _bytes(arg_leaves), _bytes(out_leaves), _bytes(alias)
    memory = {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": max(counter.peak_bytes - argument - (output - alias_b), 0),
        "peak_bytes": counter.peak_bytes,
        "alias_bytes": alias_b,
    }
    return costing.measure(counter), memory


def _variant_cfg(cfg, k_groups: int, enc_layers: Optional[int] = None):
    kw = dict(
        n_groups=k_groups,
        n_layers=len(cfg.group) * k_groups + len(cfg.tail),
    )
    if enc_layers is not None:
        kw["enc_layers"] = enc_layers
    return dataclasses.replace(cfg, **kw)


def _lin(a: dict, b: dict, f: float) -> dict:
    return {k: a[k] + f * b[k] for k in a}


def cost_by_delta(cfg, exec_cfg, shape, mesh, rules, microbatches: int = 1):
    """(CostTerms, memory, CostTerms of the largest program that ran):
    count variants with 2 and 4 layer groups, difference them for the
    per-group terms, and extrapolate to the real depth (the encoder
    likewise); a model of at most 4 groups (and 4 encoder layers) is
    counted whole.  Each group adds the same parameters, states and work,
    so the counts and the argument bytes extrapolate exactly; the peak is
    extrapolated the same way, as linear in depth."""
    shape = _shape(shape)
    ng, enc = cfg.n_groups, cfg.enc_layers

    def count(c):
        return count_cell(c, exec_cfg, shape, mesh, rules, microbatches=microbatches)

    if ng <= 4 and enc <= 4:
        cost, mem = count(cfg)
        return cost, mem, cost
    enc_small = min(enc, 2) if enc else 0
    c2, m2 = count(_variant_cfg(cfg, 2, enc_small or None))
    c4, m4 = count(_variant_cfg(cfg, 4, enc_small or None))
    per_group = (c4 + c2.scaled(-1.0)).scaled(0.5)
    total = c2 + per_group.scaled(ng - 2)
    mem = _lin(m2, _lin(m4, m2, -1.0), 0.5 * (ng - 2))
    if enc > 2 and shape.kind != "decode":  # decode never runs the encoder
        e4, me4 = count(_variant_cfg(cfg, 2, 4))
        total = total + (e4 + c2.scaled(-1.0)).scaled(0.5 * (enc - 2))
        mem = _lin(mem, _lin(me4, m2, -1.0), 0.5 * (enc - 2))
    return total, {k: int(round(v)) for k, v in mem.items()}, c4


@contextlib.contextmanager
def _world(n: int):
    """A fake process group of ``n`` ranks for the cell, or the caller's
    group when it already has ``n`` ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"dry run: the process group has {dist.get_world_size()} ranks, "
                               f"the mesh needs {n}")
        yield
        return
    with fake_process_group(n):
        yield


def run_cell(
    arch: str,
    shape_name: Union[str, ShapeSpec],
    *,
    multi_pod: bool = False,
    tiny: bool = False,
    mesh_spec=None,
    exec_overrides: Optional[dict] = None,
    cfg_overrides: Optional[dict] = None,
    microbatches: int = 1,
    fsdp: bool = True,
    sp: bool = False,
    probes: bool = True,
    verbose: bool = True,
    compiler_options: Optional[dict] = None,
    hw: HardwareSpec = H100_SXM,
) -> dict:
    """Count one cell and return the JAX package's result dict.

    ``shape_name`` is a name in ``configs.SHAPES`` or a ``ShapeSpec``;
    ``mesh_spec`` is ``(dims, axis names)`` (default: the production mesh).
    ``probes=True`` extrapolates from 2- and 4-group variants
    (:func:`cost_by_delta`), ``False`` counts the whole step.
    ``compiler_options`` (a launch point's, :func:`~repro_torch.launch.spaces.apply_launch_point`)
    is always ``{}``: PyTorch has no per-compile options."""
    if compiler_options:
        raise ValueError(f"the port has no compiler options, got {compiler_options!r}")
    t0 = time.time()
    cfg = configs.get_tiny(arch) if tiny else configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = _shape(shape_name)
    if shape.name == "long_500k" and not cfg.subquadratic and not tiny:
        return {"arch": arch, "shape": shape.name, "status": "skipped",
                "reason": "full-attention arch; long_500k runs for SSM/hybrid only"}

    exec_cfg = default_exec(cfg, shape.kind, exec_overrides)
    if mesh_spec is None:
        mesh_spec = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                     else ((16, 16), ("data", "model")))
    dims, axes = tuple(int(d) for d in mesh_spec[0]), tuple(mesh_spec[1])
    chips = math.prod(dims)
    with _world(chips):
        mesh = make_mesh(dims, axes)
        rules = default_rules(mesh, fsdp=fsdp, sp=sp)
        if probes:
            total, mem, step_cost = cost_by_delta(cfg, exec_cfg, shape, mesh, rules,
                                                  microbatches)
        else:
            total, mem = count_cell(cfg, exec_cfg, shape, mesh, rules,
                                    microbatches=microbatches)
            step_cost = total

    terms = RooflineTerms(
        compute_s=total.flops / hw.peak_for(cfg.compute_dtype),
        memory_s=total.bytes_accessed / hw.hbm_bw,
        collective_s=total.coll_bytes / (hw.link_bw * hw.links),
        flops=total.flops,
        bytes_accessed=total.bytes_accessed,
        coll_bytes=total.coll_bytes,
        chips=chips,
        hw=hw,
    )

    # model flops (6ND train / 2ND inference; N_active for MoE)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops_global = (6 if shape.kind == "train" else 2) * n_active * tokens
    model_flops_per_chip = model_flops_global / chips

    result = {
        "arch": arch,
        "shape": shape.name,
        "status": "ok",
        "mesh": dict(zip(axes, dims)),
        "chips": chips,
        "exec": dataclasses.asdict(exec_cfg),
        "fsdp": fsdp,
        "sp": sp,
        "microbatches": microbatches,
        "memory": mem,
        "cost_reported": step_cost.as_dict(),
        "cost_total_per_chip": total.as_dict(),
        "roofline": terms.as_dict(),
        "hw": hw.name,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": model_flops_per_chip / max(total.flops, 1.0),
        "params": cfg.param_count(),
        "active_params": n_active,
        "elapsed_s": round(time.time() - t0, 1),
    }
    if verbose:
        print(
            f"[dryrun] {arch} × {shape.name} ({'x'.join(map(str, dims))} mesh, "
            f"{chips} ranks): counted in {result['elapsed_s']}s\n"
            f"  mem/rank: args {mem['argument_bytes']/1e9:.2f} GB, "
            f"temp {mem['temp_bytes']/1e9:.2f} GB, peak {mem['peak_bytes']/1e9:.2f} GB\n"
            f"  roofline/rank ({hw.name}, modelled): compute {terms.compute_s*1e3:.2f} ms | "
            f"memory {terms.memory_s*1e3:.2f} ms | collective {terms.collective_s*1e3:.2f} ms "
            f"-> {terms.dominant}-bound\n"
            f"  useful-flops ratio (6ND / counted): {result['useful_flops_ratio']:.2f}",
            flush=True,
        )
    return result


def _tuned_point(db, arch: str, shape_name: str, mesh_spec, *, multi_pod: bool = False):
    """Stored launch point for this cell, trying the dryrun-mode key first
    and falling back to the deterministic model-mode key (the records
    ``pretune --launch --cost analytic`` commits)."""
    from repro_torch.launch.spaces import launch_key, launch_space

    cfg = configs.get(arch)
    shape = configs.SHAPES[shape_name]
    if mesh_spec is not None:
        n = math.prod(int(s) for s in mesh_spec[0])
    else:
        n = 512 if multi_pod else 256
    space = launch_space(cfg, shape, n)
    for mode in ("dryrun", "model"):
        rec = db.get(launch_key(arch, shape, n, space, mode=mode))
        if rec is not None:
            return dict(rec.point)
    return None


def _bound(r) -> float:
    rf = r.get("roofline") or {}
    return max(rf.get("compute_s", 0), rf.get("memory_s", 0), rf.get("collective_s", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(configs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="count the whole step instead of extrapolating 2- and 4-group variants")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], help="exec overrides k=v")
    ap.add_argument("--out", type=str, default=None, help="append JSONL here")
    ap.add_argument(
        "--mesh", type=str, default=None,
        help="override mesh shape, e.g. '4,4' (data,model) or '2,2,4' (pod,data,model): "
             "a fake process group of that many ranks",
    )
    ap.add_argument(
        "--tune", action="store_true",
        help="apply each cell's tuned launch point from --db (launch.spaces) "
             "and report tuned vs default end-to-end step estimate",
    )
    ap.add_argument("--db", type=str, default=None,
                    help="tuning DB holding launch/<arch> records (with --tune)")
    args = ap.parse_args(argv)

    mesh_spec = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
        mesh_spec = (dims, axes)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = (
            v if k in ("attn_impl", "remat") else (v == "True" if v in ("True", "False") else int(v))
        )

    if args.all:
        cells = [(a, s) for a, s, _ in configs.cells(include_skips=True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    tuned_db = None
    if args.tune:
        if not args.db:
            ap.error("--tune needs --db <tuning db with launch records>")
        from repro_torch.tuning import TuningDB

        tuned_db = TuningDB(args.db)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            cell_kw = dict(
                multi_pod=mp, tiny=args.tiny, mesh_spec=mesh_spec,
                exec_overrides=dict(overrides), microbatches=args.microbatches,
                fsdp=not args.no_fsdp, sp=args.sp, probes=not args.no_probes,
            )
            try:
                point = (_tuned_point(tuned_db, arch, shape, mesh_spec, multi_pod=mp)
                         if tuned_db is not None else None)
                if point is None:
                    r = run_cell(arch, shape, **cell_kw)
                    if tuned_db is not None:
                        r["launch_tuned"] = False
                else:
                    from repro_torch.launch.spaces import apply_launch_point

                    tuned_kw = dict(cell_kw)
                    tuned_kw.update(apply_launch_point(point, point["dp"] * point["tp"]))
                    tuned_kw["exec_overrides"] = dict(
                        overrides, **tuned_kw.pop("exec_overrides", {})
                    )
                    r = run_cell(arch, shape, **tuned_kw)
                    base = run_cell(arch, shape, **dict(cell_kw, verbose=False))
                    r["launch_tuned"] = True
                    r["launch_point"] = dict(point)
                    r["step_bound_s"] = _bound(r)
                    r["default_step_bound_s"] = _bound(base)
                    if r["status"] == "ok" and base["status"] == "ok":
                        print(
                            f"[dryrun --tune] {arch} × {shape}: tuned "
                            f"{r['step_bound_s']*1e3:.2f} ms vs default "
                            f"{r['default_step_bound_s']*1e3:.2f} ms per step"
                        )
            except Exception as e:  # one cell's failure is reported, the sweep goes on
                traceback.print_exc()
                r = {"arch": arch, "shape": shape, "status": "error", "error": repr(e)}
            r["multi_pod"] = mp
            if r["status"] != "ok":
                print(f"[dryrun] {arch} × {shape}: {r['status']} "
                      f"({r.get('reason') or r.get('error')})", flush=True)
            results.append(r)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n[dryrun] {len(results)} cells: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, {len(bad)} errors")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
