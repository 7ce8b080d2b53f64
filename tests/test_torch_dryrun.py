"""The port's dry run (``launch/{costing,dryrun,hillclimb}.py``) on the CPU:
DTensor parameters on the meta device over fake process groups, counted by
``core.costs.StepCounter``, against the JAX package where the two can be
held equal.

* the counter counts each rank's local ops only (a sharded product's FLOPs
  once, at its local shape), collectives by kind, and live bytes;
* ``attention_traffic`` equals the JAX package's bit for bit;
* ``configs.cells`` has the JAX package's 40 cells, 32 runnable (the tiny
  cells themselves count in ``tests/test_torch_dryrun_cells.py``);
* against one JAX subprocess on (2, 4) host devices (tiny qwen2 and the
  hybrid recurrentgemma at ``train_4k``): the parameters' and optimizer
  state's bytes per rank equal to the byte (the batch differs: int64 in the
  port, int32 in JAX); the port's FLOPs equal to a closed-form count of its
  products and pointwise ops; the port's FLOPs over XLA's in a measured
  band (below);
* ``cost_by_delta`` equals the whole-step count to float rounding;
* the hill climb's knob space and its CSA trajectory under one stub cost
  equal the JAX package's.

The FLOP band.  Both counts include every floating-point op: XLA's
``cost_analysis``, and the port's ``StepCounter`` (products by their
formulas, pointwise and reduction ops as XLA counts each,
``core.costs.pointwise_flops``).  Measured on these cells: port / JAX =
0.9332 (qwen2: the products are equal, 1198.3 GFLOP a rank; XLA's CPU
compile adds converts around its bf16 products that the port's card
form does not make) and 0.4714 (recurrentgemma: XLA's partitioning splits the S²
attention products 4 ways over the 8 ranks, 1099.5 GFLOP of them a rank,
where the port's per-shard product splits them 8 ways, 524).  The bands are [0.90, 0.96] and [0.44, 0.50].
"""
import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro.launch import costing as jcosting
from repro_torch import configs as tconfigs
from repro_torch.core import costs as tcosts
from repro_torch.core.costs import StepCounter
from repro_torch.launch import costing as tcosting
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.tuning.records import space_fingerprint

from helpers import REPO

PARITY = ["qwen2_7b", "recurrentgemma_2b"]
BANDS = {"qwen2_7b": (0.90, 0.96), "recurrentgemma_2b": (0.44, 0.50)}

_JAX_CELLS = f"""
import json, os
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
from repro.launch import dryrun
out = {{}}
for arch in {PARITY!r}:
    r = dryrun.run_cell(arch, "train_4k", tiny=True, mesh_spec=((2, 4), ("data", "model")),
                        verbose=False)
    out[arch] = {{"memory": r["memory"], "cost": r["cost_total_per_chip"]}}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    """One JAX subprocess on 8 host devices, started when first asked for
    and left to run while the port's cells count."""
    import os

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_CELLS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    state = {}

    def result():
        if "out" not in state:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            state["out"] = json.loads(out.split("JSON", 1)[1])
        return state["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_start_the_jax_cells(jax_cells):
    """Starts the JAX subprocess first, so that it counts while the port's
    tests below run (its result is read in ``test_parity_with_jax``)."""
    assert callable(jax_cells)


# ------------------------------------------------------------- the counter
def test_counter_counts_local_flops_once():
    """A (1024, 512) @ (512, 2048) product with the right factor sharded on
    4 fake ranks: 2·M·N·K / 4 FLOPs on rank 0 (``FlopCounterMode`` counts
    the DTensor-level op too: 2·M·N·K·(1 + 1/4))."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_process_group(4):
        mesh = make_mesh((4,), ("model",))
        a = distribute_tensor(torch.empty(1024, 512, device="meta"), mesh, [Replicate()])
        b = distribute_tensor(torch.empty(512, 2048, device="meta"), mesh, [Shard(1)])
        counter = StepCounter(device="meta")
        with counter:
            c = a @ b
        assert tuple(c.to_local().shape) == (1024, 512)
        assert counter.flops == 2 * 1024 * 512 * 2048 / 4
        # bytes: a, b's shard, c's shard, each once
        assert counter.bytes_accessed == 4 * (1024 * 512 + 512 * 512 + 1024 * 512)
        assert counter.coll_bytes == 0
        with counter:
            full = c.redistribute(mesh, [Replicate()])
        assert counter.coll["all-gather"] == 4 * 1024 * 2048
        assert tuple(full.to_local().shape) == (1024, 2048)


def test_counter_sees_alltoall_as_alltoall():
    """A shard-dim change on a cpu-typed mesh is an all-to-all of the
    local result's bytes under the dry run (DTensor's gloo fallback would
    all-gather the axis size times as much)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    with fake_process_group(4):
        mesh = make_mesh((4,), ("model",))
        x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, [Shard(0)])
        counter = StepCounter(device="meta")
        with dryrun._alltoall_as_alltoall(), counter:
            y = x.redistribute(mesh, [Shard(1)])
        assert tuple(y.to_local().shape) == (64, 8)
        assert counter.coll == {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                                "all-to-all": 4 * 64 * 8, "collective-permute": 0}


def test_counter_live_bytes_and_plain_tensors():
    counter = StepCounter()
    a = torch.randn(64, 32)
    counter.hold([a])
    with counter:
        b = a @ torch.randn(32, 16)
        c = b.t()  # a view: no bytes, no new storage
        del b
        d = c.clone()
    assert counter.flops == 2 * 64 * 32 * 16
    # held a, then b's storage (alive in the view c) and d; the randn
    # operand died after the product
    assert counter.peak_bytes == 4 * (64 * 32 + 64 * 16 + 64 * 16)
    assert d.shape == (16, 64)


# --------------------------------------------------------- attention_traffic
@pytest.mark.parametrize("shape", list(tconfigs.SHAPES))
def test_attention_traffic_equals_jax(shape):
    for arch in tconfigs.ARCH_IDS:
        for dp, tp in ((1, 1), (16, 16), (32, 16), (8, 4), (3, 5)):
            got = tcosting.attention_traffic(tconfigs.get(arch), tconfigs.SHAPES[shape], dp, tp)
            want = jcosting.attention_traffic(jconfigs.get(arch), jconfigs.SHAPES[shape], dp, tp)
            assert got == want, (arch, shape, dp, tp)


def test_cost_terms_arithmetic():
    a, b = tcosting.CostTerms(1.0, 2.0, 3.0), tcosting.CostTerms(10.0, 20.0, 30.0)
    assert (a + b).as_dict() == {"flops": 11.0, "bytes_accessed": 22.0, "coll_bytes": 33.0}
    assert a.scaled(2.0) == tcosting.CostTerms(2.0, 4.0, 6.0)


# ------------------------------------------------------------------- cells
def test_cells_are_the_jax_cells():
    cells = tconfigs.cells(include_skips=True)
    assert cells == jconfigs.cells(include_skips=True)
    assert len(cells) == 40 and sum(r for _, _, r in cells) == 32
    runnable = {(a, s): r for a, s, r in cells}
    assert runnable[("rwkv6_7b", "long_500k")] and runnable[("recurrentgemma_2b", "long_500k")]
    assert not runnable[("qwen2_7b", "long_500k")]
    assert set(tconfigs.all_configs()) == set(tconfigs.ARCH_IDS)
    r = dryrun.run_cell("qwen2_7b", "long_500k", verbose=False)
    assert r["status"] == "skipped"


def test_cost_by_delta_equals_the_whole_step():
    """Extrapolating 2- and 4-group variants to 6 groups gives the counts of
    the 6-group step counted whole, to float rounding; the argument bytes
    exactly."""
    import dataclasses

    cfg_over = dict(n_layers=6, n_groups=6)
    kw = dict(tiny=True, mesh_spec=((2, 4), ("data", "model")), cfg_overrides=cfg_over,
              verbose=False)
    delta = dryrun.run_cell("qwen2_7b", "train_4k", probes=True, **kw)
    whole = dryrun.run_cell("qwen2_7b", "train_4k", probes=False, **kw)
    for k in ("flops", "bytes_accessed", "coll_bytes"):
        assert delta["cost_total_per_chip"][k] == pytest.approx(whole["cost_total_per_chip"][k],
                                                                rel=1e-9), k
    assert delta["memory"]["argument_bytes"] == whole["memory"]["argument_bytes"]
    assert delta["memory"]["alias_bytes"] == whole["memory"]["alias_bytes"]
    # the 4-group variant is the largest program that ran
    assert delta["cost_reported"]["flops"] < delta["cost_total_per_chip"]["flops"]
    assert dataclasses.replace(tconfigs.get_tiny("qwen2_7b"), **cfg_over).n_groups == 6


# ---------------------------------------------------------------- hill climb
_STUB = """
def stub(arch, shape, knobs, **kw):
    cost = 0.0
    for i, k in enumerate(sorted(knobs)):
        cost += (i + 1) * (sum(map(ord, str(knobs[k]))) % 7)
    return 1e-3 * (1.0 + cost), {"status": "ok"}
"""

#: the JAX package's knob spaces and its hill climb under the stub, in a
#: subprocess: importing its hill climb sets the host device count
_JAX_HC = """
import json, sys
from repro import configs
import repro.launch.hillclimb as hc
from repro.tuning.records import space_fingerprint
spaces = {}
for arch, kind in (("qwen2_7b", "train"), ("moonshot_v1_16b_a3b", "train"), ("qwen2_7b", "decode")):
    s = hc.knob_space(configs.get(arch), kind)
    spaces[arch + "/" + kind] = [[(d.name, list(d.values)) for d in s.dims],
                                 space_fingerprint(s), s.size()]
print("SPACES" + json.dumps(spaces))
""" + _STUB + """
hc.evaluate = stub
sys.argv = ["hc", "--arch", "qwen2_7b", "--shape", "train_4k", "--budget", "6"]
hc.main()
"""


def _trajectory(out: str) -> list:
    return [line.split(": ", 1)[1].rsplit(" -> ", 1)[0] for line in out.splitlines()
            if line.startswith("[hc] eval ")]


def test_hillclimb_equals_jax(monkeypatch, capsys):
    """The knob spaces (dims, hash, size) equal the JAX package's, and with
    one stub cost patched into both packages' ``evaluate`` the two hill
    climbs (CSA under an OnlineTuner with a DriftDetector) ask for the same
    knob points in the same order."""
    import os

    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               REPRO_DRYRUN_DEVICES="1")
    proc = subprocess.run([sys.executable, "-c", _JAX_HC], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    spaces = json.loads(proc.stdout.split("SPACES", 1)[1].splitlines()[0])
    for key, (dims, h, size) in spaces.items():
        arch, kind = key.split("/")
        ts = hillclimb.knob_space(tconfigs.get(arch), kind)
        assert [[d.name, list(d.values)] for d in ts.dims] == dims, key
        assert space_fingerprint(ts) == h and ts.size() == size, key
    want = _trajectory(proc.stdout)

    ns: dict = {}
    exec(_STUB, ns)
    monkeypatch.setattr(hillclimb, "evaluate", ns["stub"])
    assert hillclimb.main(["--arch", "qwen2_7b", "--shape", "train_4k", "--budget", "6"]) == 0
    got = _trajectory(capsys.readouterr().out)
    assert len(got) >= 6 and got == want


def test_hillclimb_evaluates_a_tiny_point(monkeypatch):
    """``evaluate`` on the dry run: the flashcost point adds the kernel's
    FLOPs back at the card's bf16 peak; the feasibility penalty reads the
    card's 80 GB."""
    real = dryrun.run_cell

    def tiny(arch, shape, **kw):
        return real(arch, shape, tiny=True, mesh_spec=((2, 2), ("data", "model")), **kw)

    monkeypatch.setattr(hillclimb, "run_cell", tiny)
    cost, r = hillclimb.evaluate("qwen2_7b", "train_4k", {"attn_impl": "flashcost",
                                                          "remat": "full"})
    assert r["status"] == "ok" and r["flash_flops_added"] > 0
    rf = r["roofline"]
    assert rf["compute_s"] == rf["flops"] / 989e12
    assert cost == max(rf["compute_s"], rf["memory_s"], rf["collective_s"])


# ------------------------------------------------------------ JAX parity
def _closed_form_flops(arch, remat: str, pointwise: bool = True) -> float:
    """FLOPs of one tiny qwen2 train step, global.

    Products: forward, backward ×2, plus under remat="full" one forward of
    every block but its last product (the FFN's output projection, whose
    output the backward never needs, so non-reentrant checkpointing stops
    before it).

    Pointwise ops (``pointwise=True``), as ``core.costs.pointwise_flops``
    counts them (XLA's convention: 1 per element of each elementwise op,
    compare, select and convert; 0 for exp, rsqrt, cos, sin; n − 1 per
    reduction of n; softmax 4N − 2M and its backward 5N + 2M over M rows;
    silu 4, its backward 5).  With T tokens, E = B·H·S² scores a layer and
    R = E / S their rows, a layer's forward counts
      two RMSNorms 2(6·TD + T) (convert, square, mean, + eps, × rsqrt,
      × scale, convert back), the q/k/v biases 2·TD, rope on q and k
      48 + 18·S + 7.5·TD (the frequencies 3·hd/2 each, positions S and
      angles S·hd/2, the halves' converts, four products, a sum and a
      difference, the convert back), the causal mask S + 3·S², the scores
      7E − 2R (scale, mask, softmax, convert), two residual adds 2·TD, the
      SwiGLU 5·TF = 10·TD, and the weights' converts to bf16 (Pw);
    its backward 8E + 2R on the scores, 53.75·TD + 6T in autograd's other
    ops (SwiGLU 14·TD, residual sums 5·TD, the norms 2(11·TD + 3T), rope
    6.75·TD, the score product's fp32 operands and bf16 gradients 3·TD,
    the q/k gradients' sums and converts 3·TD), the bias and scale
    gradients' sums 4·TD − 256, the gradients' converts to fp32 (Pw), and
    AdamW with the clipping 18 per parameter (+1 for the norms' sum).
    Outside the layers: the final norm, the embedding's gather bounds and
    backward, the head's converts, the loss over the logits 7·TV − 2T and
    its per-token terms, AdamW on the embedding, head and final norm, and
    16 scalar ops.  Under remat="full" each layer's forward runs again
    but for its last residual add."""
    cfg = tconfigs.get_tiny(arch)
    B, S = 256, 4096
    T = B * S
    D, H, Kh, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                          cfg.padded_vocab)
    L = cfg.n_layers
    layer = (2 * T * D * H * hd + 2 * 2 * T * D * Kh * hd + 2 * T * H * hd * D
             + 3 * 2 * T * D * F + 2 * 2 * B * H * S * S * hd)
    head = 2 * T * D * V
    total = 3 * (L * layer + head)
    if remat == "full":
        total += L * (layer - 2 * T * F * D)
    if not pointwise:
        return float(total)
    TD, E = T * D, B * H * S * S
    R = E // S
    assert D == H * hd and F == 2 * D  # the coefficients below are in units of TD
    Pw = 2 * D * H * hd + 2 * D * Kh * hd + 3 * D * F + H * hd + 2 * Kh * hd
    fwd = 67 * TD // 2 + 2 * T + 48 + 19 * S + 3 * S * S + 7 * E - 2 * R + Pw
    bwd = 8 * E + 2 * R + 215 * TD // 4 + 6 * T + 4 * TD - 256 + Pw
    adamw = 18 * (Pw + 2 * D) + 1
    outside = 23 * TD + 7 * T * V + 29 * T + 18 * (2 * D * V + D) + 2 * D * V - 53
    total += L * (fwd + bwd + adamw) + outside
    if remat == "full":
        total += L * (fwd - TD)
    return float(total)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_flops_equal_the_closed_form(remat, monkeypatch):
    r = dryrun.run_cell("qwen2_7b", "train_4k", tiny=True, mesh_spec=((1, 1), ("data", "model")),
                        exec_overrides={"remat": remat}, verbose=False)
    assert r["cost_total_per_chip"]["flops"] == _closed_form_flops("qwen2_7b", remat)
    # the products alone (pointwise ops counted as none) divide by the ranks
    monkeypatch.setattr(tcosts, "pointwise_flops", lambda *a: 0.0)
    for mesh in ((1, 1), (2, 4)):
        r = dryrun.run_cell("qwen2_7b", "train_4k", tiny=True, mesh_spec=(mesh, ("data", "model")),
                            exec_overrides={"remat": remat}, verbose=False)
        n = mesh[0] * mesh[1]
        assert r["cost_total_per_chip"]["flops"] == _closed_form_flops(
            "qwen2_7b", remat, pointwise=False) / n


def test_parity_with_jax(jax_cells):
    jax = jax_cells()
    for arch in PARITY:
        cfg = tconfigs.get_tiny(arch)
        r = dryrun.run_cell(arch, "train_4k", tiny=True, mesh_spec=((2, 4), ("data", "model")),
                            verbose=False)
        # the batch per rank: tokens and labels (256, 4096) over data = 2
        tokens = 2 * 256 * 4096 // 2
        port_state = r["memory"]["argument_bytes"] - 8 * tokens  # int64
        jax_state = jax[arch]["memory"]["argument_bytes"] - 4 * tokens  # int32
        assert port_state == jax_state == r["memory"]["alias_bytes"], arch
        ratio = r["cost_total_per_chip"]["flops"] / jax[arch]["cost"]["flops"]
        lo, hi = BANDS[arch]
        assert lo <= ratio <= hi, (arch, ratio)
        assert cfg.name.endswith("tiny")
