"""Launch-level search spaces: tune the whole launch, not just kernel tiles.

Counterpart of the JAX package's ``launch/spaces.py``: the same spaces,
constraints, default points, cost model and search, so that on the same
:class:`~repro_torch.core.costs.HardwareSpec` the spaces hash alike, the
costs are the same numbers and the searches take the same trajectories.
The target is :data:`~repro_torch.core.costs.H100_SXM` unless the caller
names another, and collectives run over its NVLink links
(``hw.link_bw * hw.links``).

PATSMA's thesis is that execution parameters worth tuning live at every layer
of a parallel program.  This module registers the *launch* layer's knobs as
first-class :class:`~repro_torch.core.space.SearchSpace`s behind the existing
``Autotuning``/``search=``/DB/measure stack, so launch configs get the same
fingerprinted commit/replay/warm-start treatment as kernel tiles:

  * **mesh axis assignment** — the dp × tp factorization of the device count
    handed to ``launch.mesh.make_mesh``/``default_rules`` (fsdp rides the dp
    axis, as ``default_rules`` wires it);
  * **pipeline microbatch count** — ``parallel/pipeline.py`` /
    ``train.make_train_step(microbatches=)``;
  * **collective chunking** — ``parallel.collectives.chunked_psum`` chunk
    size for the DP gradient reduction;
  * **remat policy** — ``ExecConfig.remat`` ("none" | "dots" | "full");
  * **a curated XLA flag subspace** — :data:`XLA_PRESETS`.  PyTorch has no
    per-compile XLA options, so a preset is only its cost-model terms here
    (collective overlap, scheduler overhead) and
    :func:`compiler_options_for` is ``{}``, as the JAX package's is on every
    backend but the TPU; the dim and its four names stay so that the space
    and the search are the JAX package's.

The raw product space is intractable to measure point-by-point; declarative
validity predicates (:class:`~repro_torch.core.space.Constraint`) collapse it
before any compile: device-count factorization, batch/heads divisibility by
mesh axes, microbatch divisibility, and analytic memory feasibility against
:class:`~repro_torch.core.costs.HardwareSpec` HBM capacity.  The Autotuning driver
charges pruned points through ``skip(reason="constraint")`` at zero
compile/measure cost, and the prune counts flow through the obs completeness
identity (``asked == committed+culled+pruned+skipped+quarantined``).

Two measurement modes:

  * ``mode="model"`` — :func:`launch_cost_model`, a deterministic analytic
    step-time model (6ND compute, weight/activation HBM traffic, tp/dp
    collective terms with chunking + overlap credit).  Pure arithmetic: no
    devices, no compiles — the CI mode, byte-reproducible across hosts.
  * ``mode="dryrun"`` — count each candidate's step and charge its
    roofline bound (:func:`repro_torch.launch.dryrun.run_cell`: DTensor
    parameters on the meta device over a fake process group of
    ``n_devices`` ranks, one rank's FLOPs, bytes and collective bytes over
    the card's peaks), where the JAX package lowers on a host-platform mesh
    and reads XLA's cost analysis.  Host work: no card runs a kernel.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

from repro_torch.core.costs import H100_SXM, HardwareSpec
from repro_torch.core.space import ChoiceDim, Constraint, LogIntDim, SearchSpace
from repro_torch.obs import events as _events
from repro_torch.obs.log import get_logger

log = get_logger(__name__)

__all__ = [
    "XLA_PRESETS",
    "compiler_options_for",
    "launch_space",
    "default_launch_point",
    "launch_key",
    "launch_cost_model",
    "launch_memory_model",
    "tune_launch",
    "launch_cases",
    "apply_launch_point",
]

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

#: The JAX package's four per-compile XLA option bundles, by name, with
#: the cost model's terms for each.  Their flags are XLA's (passed to
#: ``lowered.compile()`` on a TPU) and have no PyTorch form, so a preset
#: here is its ``overlap``/``overhead`` terms only.
XLA_PRESETS = {
    "default": dict(overlap=0.0, overhead=0.0),
    "async-collectives": dict(
        overlap=0.7,  # fraction of the DP reduction hidden under compute
        overhead=0.01,  # scheduler pressure on the compute stream
    ),
    "latency-hiding": dict(overlap=0.5, overhead=0.005),
    # fully synchronous schedule: no overlap, but also no scheduler
    # overhead — the safe baseline for debugging numerical drift
    "sync-conservative": dict(overlap=0.0, overhead=0.0),
}

def compiler_options_for(preset: str, backend: Optional[str] = None) -> dict:
    """The compile options of one preset: ``{}`` on every backend (the JAX
    package's are XLA flags for the TPU only).  Raises ``KeyError`` for an
    unknown preset."""
    XLA_PRESETS[preset]
    return {}


def _pow2s(lo: int, hi: int) -> list:
    return [lo * (2**k) for k in range(int(math.floor(math.log2(hi / lo))) + 1)]


def _tp_ok(cfg, tp: int) -> bool:
    """Can the model axis shard this config ``tp`` ways?

    Attention shards heads (KV heads, or the GQA group dim — mirroring
    models.attention / costing.attention_traffic); attention-free stacks
    (RWKV, RGLRU) shard ``d_model`` directly, which every layer needs
    divisible anyway."""
    if tp == 1:
        return True
    if cfg.d_model % tp:
        return False
    if any(k in ("attn", "cross") for k in cfg.pattern):
        group = cfg.n_heads // max(cfg.n_kv_heads, 1)
        return cfg.n_heads % tp == 0 and (
            cfg.n_kv_heads % tp == 0 or group % tp == 0
        )
    return True


def launch_memory_model(cfg, shape, n_devices: int, hw: HardwareSpec = H100_SXM):
    """Analytic per-chip memory estimator for one launch point.

    Returns ``(weight_bytes_per_chip, act_bytes_fn)`` where ``act_bytes_fn``
    maps a decoded point to its resident activation bytes per chip.  Weights
    (+ grads + AdamW moments for train) shard over *all* chips — fsdp rides
    dp and tp shards the rest — so the weight term is constant across the
    dp×tp factorization; only activations are knob-controlled."""
    train = shape.kind == "train"
    pbytes = _BYTES.get(cfg.param_dtype, 4)
    # train residency: weights + grads + AdamW m,v (state_dtype=param_dtype)
    states = 4 if train else 1
    weight_bytes = cfg.param_count() * pbytes * states / n_devices
    cbytes = _BYTES.get(cfg.compute_dtype, 2)
    seq = shape.seq_len if shape.kind != "decode" else 1

    # resident checkpoints per layer: remat "full" keeps only the layer
    # boundary, "dots" a few intermediates, "none" every matmul operand
    depth = {"full": 1.0, "dots": 3.0, "none": 8.0}

    def act_bytes(point: dict) -> float:
        dp = point.get("dp", n_devices)
        tp = point.get("tp", 1)
        mb = point.get("microbatches", 1)
        remat = point.get("remat", "none")
        local_rows = max(shape.global_batch // max(dp, 1), 1)
        per_layer = (local_rows / max(mb, 1)) * seq * cfg.d_model * cbytes / tp
        if not train:
            return per_layer * 2.0  # double-buffered layer I/O, no bwd stash
        return per_layer * cfg.n_layers * depth.get(remat, 8.0)

    return weight_bytes, act_bytes


def launch_space(
    cfg,
    shape,
    n_devices: int,
    *,
    hw: HardwareSpec = H100_SXM,
    max_microbatches: int = 16,
) -> SearchSpace:
    """The launch-knob :class:`SearchSpace` for one (config, shape, devices)
    context, with its validity predicates attached as declarative
    :class:`Constraint`s — evaluated by the Autotuning driver *before*
    compile, so illegal mesh factorizations cost nothing."""
    train = shape.kind == "train"
    dims = [
        LogIntDim("dp", 1, n_devices),
        LogIntDim("tp", 1, n_devices),
    ]
    if train:
        dims.append(LogIntDim("microbatches", 1, max_microbatches))
        dims.append(ChoiceDim("remat", ("none", "dots", "full")))
    dims.append(LogIntDim("coll_chunk_mb", 1, 64))
    dims.append(ChoiceDim("xla", tuple(XLA_PRESETS)))

    constraints = [
        Constraint(
            "device-factorization",
            lambda p: p["dp"] * p["tp"] == n_devices,
            describe=f"dp * tp == {n_devices} (every chip owns exactly one shard)",
        ),
        Constraint(
            "batch-divisible",
            lambda p: shape.global_batch % p["dp"] == 0,
            describe=f"global batch {shape.global_batch} % dp == 0",
        ),
        Constraint(
            "model-divisible",
            lambda p: _tp_ok(cfg, p["tp"]),
            describe=f"heads {cfg.n_heads}/{cfg.n_kv_heads} (or d_model) % tp == 0",
        ),
    ]
    if train:
        constraints.append(
            Constraint(
                "microbatch-divisible",
                lambda p: (shape.global_batch // p["dp"]) % p["microbatches"] == 0
                if shape.global_batch % p["dp"] == 0
                else False,
                describe="local batch % microbatches == 0",
            )
        )

    # memory feasibility: weights shard over all chips regardless of the
    # dp×tp split, so the predicate discriminates via activations.  If even
    # the leanest activation point overflows (or weights alone do), no point
    # in THIS space can fix it — more chips can, which is outside the space —
    # so the predicate abstains instead of declaring everything illegal (the
    # cost model still penalizes overflow smoothly).
    weight_bytes, act_bytes = launch_memory_model(cfg, shape, n_devices, hw)
    headroom = hw.hbm_bytes - weight_bytes
    lean = dict(dp=1, tp=n_devices, microbatches=max_microbatches, remat="full")
    lean["dp"] = max(d for d in _pow2s(1, n_devices) if shape.global_batch % d == 0)
    lean["tp"] = n_devices // lean["dp"]
    discriminates = headroom > 0 and act_bytes(lean) <= headroom
    if discriminates:
        constraints.append(
            Constraint(
                "memory-feasible",
                lambda p: act_bytes(p) <= headroom,
                describe=(
                    f"resident activations ≤ {headroom / 1e9:.2f} GB HBM "
                    f"headroom ({hw.name})"
                ),
            )
        )
    return SearchSpace(dims, constraints=constraints)


def default_launch_point(cfg, shape, n_devices: int, space: Optional[SearchSpace] = None) -> dict:
    """The untuned launch — what the zoo/dryrun defaults do today: widest
    legal dp, modest tp, one microbatch, ``default_exec``'s remat policy,
    one big all-reduce, stock flags.  Bumped along the memory knobs until
    the space's own feasibility predicate accepts it."""
    train = shape.kind == "train"
    tp = 1
    for cand in _pow2s(1, n_devices):
        if cand * cand > n_devices:
            break
        if n_devices % cand == 0 and _tp_ok(cfg, cand):
            tp = cand
    point: dict = {"dp": n_devices // tp, "tp": tp}
    if train:
        point["microbatches"] = 1
        point["remat"] = "full"  # default_exec: remat="full" for train
    point["coll_chunk_mb"] = 64  # one (near-)monolithic reduction
    point["xla"] = "default"
    if space is not None and space.check(point) is not None:
        local = shape.global_batch // point["dp"]
        for mb in _pow2s(1, 16):
            if local % mb:
                continue
            point["microbatches"] = mb
            if space.check(point) is None:
                break
    return point


def launch_key(
    arch: str,
    shape,
    n_devices: int,
    space: SearchSpace,
    *,
    mode: str = "model",
    hw: HardwareSpec = H100_SXM,
):
    """Context fingerprint for one launch-tuning site.

    Launch contexts have **no array arguments** — the signature is empty and
    ``TuningKey.shapes()`` is None; the context lives in ``extra`` (shape
    name, device count) plus the space hash.  Model-mode keys pin
    ``backend="model"`` / the target hardware name so the deterministic
    records replay identically on any host; dryrun-mode keys use the real
    default device like every kernel key."""
    from repro_torch.tuning import make_key

    kw: dict = {}
    if mode == "model":
        kw = dict(backend="model", device_kind=hw.name)
    return make_key(
        f"launch/{arch}",
        args=(),
        space=space,
        extra={"shape": shape.name, "devices": int(n_devices), "mode": mode},
        **kw,
    )


def launch_cost_model(
    cfg, shape, n_devices: int, hw: HardwareSpec = H100_SXM
) -> Callable[[dict], float]:
    """Deterministic analytic step time (seconds) of one launch point.

    Terms (per chip): 6ND/2ND compute with remat recompute and preset
    scheduler overhead; HBM traffic of streamed weights + activation
    checkpoints; tp all-reduces (per-layer activation reductions, exposed);
    dp gradient reduce-scatter/all-gather with per-chunk dispatch latency
    and the preset's async overlap credit (which needs ≥2 chunks to bite —
    that is exactly the chunking/flags interaction worth tuning); microbatch
    loop overhead; and a smooth paging penalty when the estimated residency
    overflows HBM (for the degenerate spaces where the feasibility predicate
    abstains).  It is a *model* — monotone in the right directions and
    deterministic for CI — not a measurement; ``mode="dryrun"`` is the
    measured path."""
    train = shape.kind == "train"
    seq = shape.seq_len if shape.kind != "decode" else 1
    tokens = shape.global_batch * seq
    n_active = cfg.active_param_count()
    flops_global = (6 if train else 2) * n_active * tokens
    pbytes = _BYTES.get(cfg.param_dtype, 4)
    cbytes = _BYTES.get(cfg.compute_dtype, 2)
    weight_bytes, act_bytes = launch_memory_model(cfg, shape, n_devices, hw)
    recompute = {"none": 1.0, "dots": 7.0 / 6.0, "full": 4.0 / 3.0}
    act_passes = {"none": 2.0, "dots": 2.5, "full": 3.0}
    links = hw.links
    chunk_latency = 20e-6  # per-collective dispatch cost
    mb_latency = 50e-6  # per-microbatch loop/dispatch cost

    def cost(point: dict) -> float:
        dp = int(point.get("dp", n_devices))
        tp = int(point.get("tp", 1))
        mb = int(point.get("microbatches", 1))
        remat = point.get("remat", "none")
        preset = XLA_PRESETS[point.get("xla", "default")]
        local_tokens = tokens / dp

        compute_s = (
            flops_global / n_devices / hw.peak_flops
            * recompute.get(remat, 1.0)
            * (1.0 + preset["overhead"])
        )

        # HBM: stream weights (fwd + bwd + optimizer sweep for train) and
        # activation checkpoints (written fwd, read bwd, re-read on remat)
        weight_traffic = (cfg.param_count() * pbytes / n_devices) * (3.0 if train else 1.0)
        act_traffic = (
            local_tokens * cfg.d_model * cbytes * cfg.n_layers
            * act_passes.get(remat, 2.0) / tp
        )
        memory_s = (weight_traffic + act_traffic) / hw.hbm_bw

        # tp: two all-reduces per layer (attn out + mlp out) over the local
        # activation slab, doubled for the backward pass — latency-exposed
        coll_s = 0.0
        if tp > 1:
            tp_bytes = (
                2.0 * cfg.n_layers * local_tokens * cfg.d_model * cbytes
                * (2.0 if train else 1.0) * (tp - 1) / tp
            )
            tp_ops = 2.0 * cfg.n_layers * (2.0 if train else 1.0)
            tp_s = tp_bytes / (hw.link_bw * links) + tp_ops * chunk_latency
            coll_s += tp_s * (1.0 - 0.5 * preset["overlap"])

        # dp: ring-style gradient reduction of the tp-sharded grads; chunking
        # adds dispatch latency but enables the async presets' overlap
        if train and dp > 1:
            dp_bytes = 2.0 * (dp - 1) / dp * (cfg.param_count() * pbytes / tp)
            chunk = float(point.get("coll_chunk_mb", 64)) * 1e6
            n_chunks = max(1, int(math.ceil(dp_bytes / chunk)))
            dp_s = dp_bytes / (hw.link_bw * links) + n_chunks * chunk_latency
            overlap_eff = preset["overlap"] * (1.0 - 1.0 / n_chunks)
            coll_s += dp_s * (1.0 - overlap_eff)

        step = max(compute_s, memory_s) + coll_s + (mb - 1) * mb_latency

        resident = weight_bytes + act_bytes(point)
        if resident > hw.hbm_bytes:
            step *= resident / hw.hbm_bytes  # paging penalty (abstained spaces)
        return float(step)

    return cost


def apply_launch_point(point: dict, n_devices: int, backend: Optional[str] = None) -> dict:
    """Translate a decoded launch point into the keyword arguments of the
    dry run's :func:`~repro_torch.launch.dryrun.run_cell`."""
    kw: dict = {
        "mesh_spec": ((int(point["dp"]), int(point["tp"])), ("data", "model")),
        "microbatches": int(point.get("microbatches", 1)),
        "compiler_options": compiler_options_for(point.get("xla", "default"), backend),
    }
    if "remat" in point:
        kw["exec_overrides"] = {"remat": point["remat"]}
    return kw


def _dryrun_cost_fn(arch: str, shape, n_devices: int, *, tiny: bool = False,
                    hw: HardwareSpec = H100_SXM):
    """mode="dryrun": count each candidate's whole step on a fake process
    group of ``n_devices`` ranks and charge its roofline bound (the max of
    the compute, memory and collective time per rank on ``hw``)."""

    def cost(point: dict) -> float:
        from repro_torch.launch import dryrun

        kw = apply_launch_point(point, n_devices)
        r = dryrun.run_cell(arch, shape.name, tiny=tiny, probes=False, verbose=False, hw=hw,
                            **kw)
        if r.get("status") != "ok":
            return float("inf")
        rf = r["roofline"]
        return float(max(rf["compute_s"], rf["memory_s"], rf["collective_s"]))

    return cost


def tune_launch(
    arch: str,
    shape_name: str,
    n_devices: int,
    *,
    db=None,
    mode: str = "model",
    num_opt: int = 3,
    max_iter: int = 8,
    seed: int = 0,
    search: Any = None,
    warm_start: bool = True,
    source: str = "pretune",
    hw: HardwareSpec = H100_SXM,
    tiny: bool = False,
    stats: Optional[dict] = None,
    verbose: bool = False,
):
    """Tune the launch knobs of one (arch, shape) context; returns the
    :class:`~repro_torch.tuning.TuningRecord` (committed to ``db`` when given).

    The default point is fed to the search via :meth:`Autotuning.note`
    before any round, so the committed best is ≤ the untuned launch by
    construction — tuning can only improve on the incumbent.  ``stats``
    (optional dict) is filled with space/prune/measure accounting:
    ``raw_size``, ``constrained_size``, ``pruned``, ``measured``,
    ``default_cost``, ``best_cost``, ``replayed``."""
    from repro_torch import configs
    from repro_torch.core import Autotuning
    from repro_torch.tuning.warm_start import record_from

    if mode not in ("model", "dryrun"):
        raise ValueError(f"mode must be 'model' or 'dryrun', got {mode!r}")
    cfg = configs.get(arch) if not tiny else configs.get_tiny(arch)
    shape = configs.SHAPES[shape_name]
    space = launch_space(cfg, shape, n_devices, hw=hw)
    key = launch_key(arch, shape, n_devices, space, mode=mode, hw=hw)
    cost_fn = (
        launch_cost_model(cfg, shape, n_devices, hw)
        if mode == "model"
        else _dryrun_cost_fn(arch, shape, n_devices, tiny=tiny, hw=hw)
    )
    default_pt = default_launch_point(cfg, shape, n_devices, space)
    if stats is None:
        stats = {}
    stats.update(
        raw_size=space.size(),
        constrained_size=space.constrained_size(),
        measured=0,
        default_point=dict(default_pt),
        default_cost=None,
        replayed=False,
    )

    at = Autotuning(
        space=space,
        search=search,
        num_opt=num_opt,
        max_iter=max_iter,
        seed=seed,
        cache=True,
        verbose=verbose,
        db=db,
        key=key,
        warm_start=warm_start,
        db_source=source,
    )
    if at.finished and at.warm_started:
        # exact fingerprint hit: replay, zero measurements
        stats["replayed"] = True
        stats["default_cost"] = float(cost_fn(default_pt))
        stats["best_cost"] = at.best_cost
        stats["pruned"] = 0
        return db.get(key) if db is not None else None

    # the incumbent (untuned default) joins the history out-of-band: commit
    # can only improve on it
    default_cost = float(cost_fn(default_pt))
    stats["default_cost"] = default_cost
    at.note(default_pt, default_cost)

    rnd = [0]

    def measure_batch(points):
        stats["measured"] += len(points)
        costs = [cost_fn(p) for p in points]
        if _events.sink() is not None:
            rnd[0] += 1
            sname = at.ctx_name()
            for p, c in zip(points, costs):
                _events.emit("candidate_asked", name=sname, point=dict(p),
                             round=rnd[0])
                if math.isfinite(c):
                    _events.emit("candidate_committed", name=sname,
                                 point=dict(p), cost=float(c))
                else:
                    _events.emit("candidate_skipped", name=sname,
                                 point=dict(p), reason="failed")
        return costs

    at.entire_exec_batch(measure_batch)
    stats["pruned"] = int(at.skip_reasons.get("constraint", 0))
    stats["constraint_violations"] = dict(at.constraint_violations)
    stats["best_point"] = dict(at.best_point)
    stats["best_cost"] = float(at.best_cost)
    if db is not None:
        rec = db.get(key)
        if rec is not None:
            return rec
    return record_from(at, key, source=source)


def launch_cases(smoke: bool = True) -> list:
    """(arch, shape_name) launch-tuning grid.  Smoke: the three zoo configs
    the benchmark reports; full: every arch on the train shape plus the two
    serving shapes for the smoke archs."""
    smoke_cases = [
        ("qwen2_7b", "train_4k"),
        ("recurrentgemma_2b", "train_4k"),
        ("moonshot_v1_16b_a3b", "train_4k"),
    ]
    if smoke:
        return smoke_cases
    from repro_torch import configs

    cases = [(a, "train_4k") for a in configs.ARCH_IDS]
    cases += [(a, "prefill_32k") for a, _ in smoke_cases]
    cases += [(a, "decode_32k") for a, _ in smoke_cases]
    return cases
