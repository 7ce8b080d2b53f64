"""The port's collectives, pipeline and compressed data-parallel step on 4
ranks, against the JAX package's on 4 host devices, on the CPU.

One gloo group of 4 spawned ranks runs the port (``torch.distributed``,
a ``("data",)`` mesh, and a 2-rank subgroup for the chunked reduction at
world 2); one JAX subprocess runs the JAX package under ``shard_map`` on 4
forced host devices (``tests/helpers.py::run_py``).  Both read the same
numpy inputs and the same tiny qwen2 weights (the JAX ``Model.init``,
carried over by ``params_from_jax``), and each writes what it computed; the
tests compare the two.  Tolerances:

* ``int8_psum``: bit-equal (the same int32 sums of the same quanta, and the
  same fp32 max, scale and dequantization);
* ``topk_psum``, two error-feedback rounds: 1e-6 relative (the kept entries
  are the same; their fp32 sum over 4 ranks is taken in another order);
* ``chunked_psum`` at world 2: bit-equal to JAX's and to one whole
  all-reduce (a sum of two numbers has one order); at world 4 within 1e-6
  (absolute and relative) of JAX's and of the port's own whole all-reduce:
  gloo sums an element of a chunk in another order than the same element
  of the whole tensor (measured: one ulp, 9.5e-7 at values up to 8);
* ``gpipe_apply``: forward 1e-5, gradients 1e-4 (the JAX test's limits);
* ``make_compressed_dp_step`` (``exact``, ``int8``, ``topk``), 2 steps of a
  tiny qwen2 in fp32 under plain SGD (lr 1e-2): losses and every parameter
  within 1e-5; under AdamW (``exact``): losses within 1e-5.

Why the parameters are held under SGD.  The two frameworks' fp32
gradients differ in summation order (about 1e-9 here).  AdamW's first
steps divide each gradient by its own magnitude, so an element whose
gradient is near ``eps`` = 1e-8 turns that into ~1e-4 (measured: after two
``exact`` AdamW steps 2 of 139,840 parameters were beyond 1e-5, the
largest 1.1e-4); and an int8 rounding or a top-k selection that falls the
other way at its boundary becomes a whole AdamW step (lr) for that element
(hundreds of elements per leaf).  SGD's update is linear in the gradient,
so what the test sees is the reduction itself: a flipped int8 quantum or
a swapped top-k entry moves a parameter by lr times that quantum or entry.

The unit of compression.  int8's scale and top-k's threshold are per
tensor.  The port's tensors are one per layer; the JAX package's leaves
stack each repeating group's layers on a leading dim, so there one scale
and one threshold cover all the layers of a group position.  The tiny qwen2
here is laid out as one group of its two layers (``group=("attn",
"attn")``, ``n_groups=1``: the same two layers and weights), so that each
JAX leaf is one layer's tensor and the two packages compress the same
units; with the stock layout (two groups of one) they do not, and top-k
then keeps other entries.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

from helpers import REPO, run_py

WORLD = 4
METHODS = ("exact", "int8", "topk")
RUNS = tuple(("sgd", m) for m in METHODS) + (("adamw", "exact"),)  # (optimizer, method)
LR = 1e-2  # SGD's
# the tiny qwen2 in fp32, its two layers laid out as one group of two
# positions: each JAX leaf is then one layer's tensor (see the docstring)
CFG = dict(compute_dtype="float32", group=("attn", "attn"), n_groups=1)
CHUNKS = (64, 256, 10**9)  # many chunks, a few, and one monolithic reduction
STEPS, B, S = 2, 8, 16
K_RATIO = 0.1

_JAX = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.parallel._compat import shard_map
from repro.parallel.collectives import int8_psum, topk_psum, chunked_psum, make_compressed_dp_step
from repro.parallel.pipeline import gpipe_apply
from repro import configs
from repro.models import Model, ExecConfig
from repro.optim import AdamW
from repro.train import make_loss_fn

d = dict(np.load(sys.argv[1]))
out = {}
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
mesh2 = Mesh(np.array(jax.devices()[:2]), ("data",))

def over(m, f, *xs, out_specs=P()):
    spec = tuple(P("data", *([None] * (x.ndim - 1))) for x in xs)
    return shard_map(f, mesh=m, in_specs=spec, out_specs=out_specs, check_vma=False)(*xs)

g = jnp.asarray(d["g"])
out["int8"] = over(mesh, lambda gl: int8_psum(gl[0], "data"), g)

def ftk(gl, el):
    r, ne = topk_psum(gl[0], "data", K_RATIO, el[0])
    return r, ne[None]
r1, ne1 = over(mesh, ftk, g, jnp.zeros_like(g), out_specs=(P(), P("data", None, None)))
r2, ne2 = over(mesh, ftk, jnp.asarray(d["g2"]), ne1, out_specs=(P(), P("data", None, None)))
out.update(topk_r1=r1, topk_e1=ne1, topk_r2=r2, topk_e2=ne2)

for cb in CHUNKS:
    out[f"chunked4_{cb}"] = over(mesh, lambda gl: chunked_psum(gl[0], "data", cb), g)
    out[f"chunked2_{cb}"] = over(mesh2, lambda gl: chunked_psum(gl[0], "data", cb), g[:2])

pmesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
w, x = jnp.asarray(d["pipe_w"]), jnp.asarray(d["pipe_x"])
stage_fn = lambda wp, xmb: jnp.tanh(xmb @ wp)
out["pipe_y"] = gpipe_apply(pmesh, "pod", stage_fn, w, x)
out["pipe_gw"] = jax.grad(lambda w: jnp.sum(gpipe_apply(pmesh, "pod", stage_fn, w, x) ** 2))(w)

cfg = dataclasses.replace(configs.get_tiny("qwen2_7b"), **CFG)
model = Model(cfg, ExecConfig())
params0 = model.init(jax.random.PRNGKey(0))
class SGD:
    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return jax.tree.map(lambda p, g: p - LR * g, params, grads), state, {}

for opt_name, method in RUNS:
    opt = SGD() if opt_name == "sgd" else AdamW(lr=1e-3)
    step, init_err = make_compressed_dp_step(make_loss_fn(model), opt, mesh, method=method,
                                             k_ratio=K_RATIO)
    step = jax.jit(step)
    p, o, e = params0, opt.init(params0), init_err(params0)
    losses = []
    for i in range(STEPS):
        batch = {"tokens": jnp.asarray(d[f"tokens{i}"]), "labels": jnp.asarray(d[f"labels{i}"])}
        p, o, e, m = step(p, o, e, batch)
        losses.append(float(m["loss"]))
    out[f"dp_{opt_name}_{method}_loss"] = np.array(losses)
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        out[f"dp_{opt_name}_{method}_param/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                            for k in path)] = leaf
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""

_RANK = """
import dataclasses, os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.parallel.collectives import (chunked_psum, int8_psum, make_compressed_dp_step,
                                              topk_psum)
from repro_torch.parallel.pipeline import gpipe_apply
from repro_torch import configs
from repro_torch.models import ExecConfig, TrainModel
from repro_torch.optim import AdamW
from repro_torch.train import make_loss_fn

dist.init_process_group("gloo")
rank = dist.get_rank()
d = dict(np.load(sys.argv[1]))
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
group = mesh.get_group("data")
pair = dist.new_group([0, 1])
out = {}
t = lambda a: torch.from_numpy(np.array(a))

g = t(d["g"])[rank]
out["int8"] = int8_psum(g, group)
r1, e1 = topk_psum(g, group, K_RATIO, torch.zeros_like(g))
r2, e2 = topk_psum(t(d["g2"])[rank], group, K_RATIO, e1)
out.update(topk_r1=r1, topk_e1=e1, topk_r2=r2, topk_e2=e2)
whole = g.clone()
dist.all_reduce(whole, group=group)
out["whole4"] = whole
if rank < 2:
    whole2 = g.clone()
    dist.all_reduce(whole2, group=pair)
    out["whole2"] = whole2
for cb in CHUNKS:
    out[f"chunked4_{cb}"] = chunked_psum(g, group, cb)
    if rank < 2:
        out[f"chunked2_{cb}"] = chunked_psum(g, pair, cb)
try:
    chunked_psum(g, group, 0)
    raise SystemExit("chunk_bytes=0 must raise")
except ValueError:
    pass

w = t(d["pipe_w"]).requires_grad_(True)
x = t(d["pipe_x"])
stage_fn = lambda wp, xmb: torch.tanh(xmb @ wp)
y = gpipe_apply(mesh, "data", stage_fn, w, x)
(y ** 2).sum().backward()
gw = w.grad.clone()
dist.all_reduce(gw, group=group)  # each rank holds its stage's slice of the gradient
out.update(pipe_y=y.detach(), pipe_gw=gw)

cfg = dataclasses.replace(configs.get_tiny("qwen2_7b"), **CFG)
state = torch.load(sys.argv[3])


class SGD:
    def init(self, params):
        return {}

    @torch.no_grad()
    def update(self, grads, state, params):
        for n, p in params.items():
            p.sub_(LR * grads[n])
        return params, state, {}


for opt_name, method in RUNS:
    model = TrainModel(cfg, ExecConfig(), device="cpu")
    model.load_state_dict(state)
    params = model.params()
    opt = SGD() if opt_name == "sgd" else AdamW(lr=1e-3)
    step, init_err = make_compressed_dp_step(make_loss_fn(model), opt, mesh, method=method,
                                             k_ratio=K_RATIO)
    o, e = opt.init(params), init_err(params)
    losses = []
    for i in range(STEPS):
        batch = {"tokens": t(d[f"tokens{i}"]).long(), "labels": t(d[f"labels{i}"]).long()}
        params, o, e, m = step(params, o, e, batch)
        losses.append(float(m["loss"]))
    out[f"dp_{opt_name}_{method}_loss"] = torch.tensor(losses)
    for n, p in params.items():
        out[f"dp_{opt_name}_{method}_param/{n}"] = p.detach()
np.savez(sys.argv[2] + f".{rank}.npz", **{k: v.numpy() for k, v in out.items()})
dist.destroy_process_group()
"""

_CONSTS = (f"CHUNKS = {CHUNKS!r}\nRUNS = {RUNS!r}\nSTEPS = {STEPS}\nK_RATIO = {K_RATIO}\n"
           f"LR = {LR}\nCFG = {CFG!r}\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs, once: {"jax": {...}, "ranks": [{...} x 4]}."""
    import dataclasses

    import jax
    import torch

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro_torch import configs as tconfigs
    from repro_torch.models.convert import params_from_jax

    tmp = tmp_path_factory.mktemp("collectives")
    rs = np.random.RandomState(0)
    inputs = {
        "g": rs.standard_normal((WORLD, 257, 33)).astype(np.float32),
        "g2": np.zeros((WORLD, 257, 33), np.float32),  # round 2: the residuals alone
        "pipe_w": (rs.standard_normal((WORLD, 16, 16)) / 4.0).astype(np.float32),
        "pipe_x": rs.standard_normal((6, 3, 16)).astype(np.float32),
    }
    for i in range(STEPS):
        toks = rs.randint(0, 512, (B, S + 1))
        inputs[f"tokens{i}"], inputs[f"labels{i}"] = toks[:, :-1], toks[:, 1:]
    np.savez(tmp / "inputs.npz", **inputs)
    cfg = dataclasses.replace(tconfigs.get_tiny("qwen2_7b"), **CFG)
    jparams = JModel(dataclasses.replace(jconfigs.get_tiny("qwen2_7b"), **CFG)).init(
        jax.random.PRNGKey(0))
    state0 = params_from_jax(cfg, jparams)
    torch.save(state0, tmp / "state.pt")

    script = tmp / "rank.py"
    script.write_text(_CONSTS + textwrap.dedent(_RANK))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp / "inputs.npz"),
                               str(tmp / "torch"), str(tmp / "state.pt")],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        # the JAX run meanwhile, on 4 forced host devices
        run_py(_CONSTS + _JAX.replace("sys.argv[1]", repr(str(tmp / "inputs.npz")))
               .replace("sys.argv[2]", repr(str(tmp / "jax.npz"))), devices=WORLD, timeout=300)
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"inputs": inputs, "state0": {k: v.numpy() for k, v in state0.items()},
            "jax": dict(np.load(tmp / "jax.npz")),
            "ranks": [dict(np.load(f"{tmp / 'torch'}.{r}.npz")) for r in range(WORLD)]}


def test_int8_psum_bit_equal(runs):
    want = runs["jax"]["int8"]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["int8"], want)


def test_int8_psum_tracks_the_exact_sum(runs):
    exact = runs["ranks"][0]["whole4"]
    rel = np.max(np.abs(runs["ranks"][0]["int8"] - exact)) / np.max(np.abs(exact))
    assert rel < 0.05, rel


@pytest.mark.parametrize("name", ["topk_r1", "topk_r2"])
def test_topk_psum_two_error_feedback_rounds(runs, name):
    want = runs["jax"][name]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[name], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["topk_e1", "topk_e2"])
def test_topk_residuals_equal_jax(runs, name):
    for i, r in enumerate(runs["ranks"]):
        np.testing.assert_allclose(r[name], runs["jax"][name][i], rtol=1e-6,
                                   atol=1e-6 * np.abs(runs["jax"][name]).max())


def test_topk_error_feedback_shrinks_the_gap(runs):
    """Round 2 reduces a zero gradient plus round 1's residuals, so the two
    rounds together come closer to the exact sum than round 1 alone (the
    JAX test's check)."""
    exact = runs["ranks"][0]["whole4"]
    r = runs["ranks"][0]
    gap1 = np.linalg.norm(r["topk_r1"] - exact)
    gap2 = np.linalg.norm(r["topk_r1"] + r["topk_r2"] - exact)
    assert gap2 < gap1, (gap1, gap2)


@pytest.mark.parametrize("cb", CHUNKS)
def test_chunked_psum_world2_bit_equal(runs, cb):
    for r in runs["ranks"][:2]:
        np.testing.assert_array_equal(r[f"chunked2_{cb}"], runs["jax"][f"chunked2_{cb}"])
        np.testing.assert_array_equal(r[f"chunked2_{cb}"], r["whole2"])


@pytest.mark.parametrize("cb", CHUNKS)
def test_chunked_psum_world4(runs, cb):
    want = runs["jax"][f"chunked4_{cb}"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"chunked4_{cb}"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r[f"chunked4_{cb}"], r["whole4"], rtol=1e-6, atol=1e-6)


def test_gpipe_forward_and_gradients(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["pipe_y"], runs["jax"]["pipe_y"], atol=1e-5)
        np.testing.assert_allclose(r["pipe_gw"], runs["jax"]["pipe_gw"], atol=1e-4)


def test_gpipe_matches_sequential_oracle(runs):
    w, x = runs["inputs"]["pipe_w"].astype(np.float64), runs["inputs"]["pipe_x"].astype(np.float64)
    want = x
    for s in range(WORLD):
        want = np.tanh(want @ w[s])
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["pipe_y"], want, atol=1e-5)


@pytest.mark.parametrize("opt_name,method", RUNS)
def test_compressed_dp_step_losses(runs, opt_name, method):
    want = runs["jax"][f"dp_{opt_name}_{method}_loss"]
    assert want.shape == (STEPS,)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"dp_{opt_name}_{method}_loss"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
def test_compressed_dp_step_parameters(runs, method):
    import dataclasses

    from repro_torch import configs as tconfigs
    from repro_torch.models.convert import params_from_jax

    prefix = f"dp_sgd_{method}_param/"
    tree: dict = {}
    for key, leaf in runs["jax"].items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, last = key[len(prefix):].split("/")
        for part in parents:
            node = node.setdefault(int(part) if part.isdigit() else part, {})
        node[last] = leaf
    tree["stages"] = [tree["stages"][i] for i in sorted(tree["stages"])]
    cfg = dataclasses.replace(tconfigs.get_tiny("qwen2_7b"), **CFG)
    want = params_from_jax(cfg, tree)
    for r in runs["ranks"]:
        got = {k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}
        assert sorted(got) == sorted(want)
        for name, v in got.items():
            np.testing.assert_allclose(v, want[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    # the steps moved every parameter that the batches reach
    assert not np.array_equal(runs["ranks"][0][prefix + "lm_head.w"], runs["state0"]["lm_head.w"])
