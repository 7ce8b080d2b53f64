"""The port's sharding layer against the JAX package's, on the CPU: the
sharding-rule units of ``tests/test_parallel.py`` on the port's names, the
wanted axes of every parameter leaf of the ten configs at full size (meta
tensors, no storage), the decode states and batches, ``logical_spec`` over
a grid of shapes, rules and meshes, the placements on the production
meshes, ``default_rules``, ``wire_bytes``, ``constrain`` and the device
pool of the fleet.

JAX's ``logical_spec`` only reads ``mesh.shape``, so a stub mesh stands in
for a JAX mesh of 256 or 512 devices.  The port's meshes are real
``DeviceMesh``es on a fake process group of that many ranks (no data
moves).  Everything here is exact: the specs, axes and placements are
equal or the test fails.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro.launch.mesh import default_rules as jdefault_rules
from repro.models import Model as JModel
from repro.parallel import api as japi
from repro.parallel import sharding as jsharding
from repro.parallel.collectives import wire_bytes as jwire_bytes
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import default_rules, fake_process_group, make_mesh, make_production_mesh
from repro_torch.models import TrainModel
from repro_torch.models.convert import stage_defs
from repro_torch.parallel import api as tapi
from repro_torch.parallel import sharding as tsharding
from repro_torch.parallel.collectives import wire_bytes

ARCHS = list(tconfigs.ARCH_IDS)


@dataclasses.dataclass
class _StubMesh:
    """What JAX's ``logical_spec`` and ``default_rules`` read of a mesh."""

    shape: dict


def _pw(name, shape):
    return tsharding.param_wanted(tsharding.path_str(name), shape)


# ------------------------------------------------------ sharding rule units
def test_param_wanted_attention():
    assert _pw("layers.1.attn.wq.w", 2) == ("fsdp", "tp")
    assert _pw("layers.1.attn.wo.w", 2) == ("tp", "fsdp")
    assert _pw("layers.1.attn.wq.b", 1) == ("tp",)
    assert _pw("embedding.table", 2) == ("tp", "fsdp")
    assert _pw("lm_head.w", 2) == ("fsdp", "tp")
    assert _pw("encoder.3.attn.wk.w", 2) == ("fsdp", "tp")


def test_param_wanted_moe_vs_dense():
    # expert weights (E, D, F) -> EP on experts
    assert _pw("layers.0.ffn.wi", 3) == ("ep", "fsdp", None)
    assert _pw("layers.0.ffn.wo", 3) == ("ep", None, "fsdp")
    # dense ffn (D, F)
    assert _pw("layers.0.ffn.wi", 2) == ("fsdp", "tp")
    assert _pw("layers.0.ffn.dense.wi", 2) == ("fsdp", "tp")
    assert _pw("layers.0.ffn.router", 2) == ("fsdp", None)


def test_param_wanted_norms_replicated():
    assert _pw("layers.0.norm1.scale", 1) == (None,)
    assert _pw("final_norm.scale", 1) == (None,)
    assert _pw("encoder_norm.scale", 1) == (None,)


def test_path_str_writes_the_jax_form():
    assert tsharding.path_str("embedding.table") == "embed/table"
    assert tsharding.path_str("encoder_norm.scale") == "encoder/norm/scale"
    assert tsharding.path_str("layers.3.attn.wq.w") == "layers/3/attn/wq/w"
    assert tsharding.path_str((3, "kv", "k")) == "3/kv/k"
    assert tsharding.path_str(("layers.3.attn", "wq.w")) == "layers/3/attn/wq/w"


def test_state_wanted():
    sw = tsharding.state_wanted
    assert sw("0/kv/k", 4) == ("dp", "tp", None, None)
    # GQA kv=8 on 16-way model axis: prefer the sharded-sequence KV layout
    assert sw("0/kv/k", (128, 8, 32768, 128), tp_size=16) == ("dp", None, "tp", None)
    assert sw("0/kv/k", (128, 16, 32768, 128), tp_size=16) == ("dp", "tp", None, None)
    assert sw("0/kv/pos", 1) == (None,)
    assert sw("0/wkv", 4) == ("dp", "tp", None, None)
    assert sw("0/h", 2) == ("dp", "tp")
    assert sw("0/conv", 3) == ("dp", None, "tp")


def test_shapes_equal_jax():
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


# ------------------------------------- every parameter leaf of the ten configs
def _jax_leaves(tree):
    return {jsharding.path_str(p): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


_JAX_PARAMS = {}


def _jax_param_shapes(arch):
    if arch not in _JAX_PARAMS:
        model = JModel(jconfigs.get(arch))
        _JAX_PARAMS[arch] = _jax_leaves(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    return _JAX_PARAMS[arch]


def _layer_places(cfg):
    """Port layer index -> (JAX stage, group, position in the group)."""
    out = []
    for s, (kinds, n_groups) in enumerate(stage_defs(cfg)):
        for g in range(n_groups):
            for i in range(len(kinds)):
                out.append((s, g, i))
    return out


def _jax_name(cfg, name):
    """(JAX path, stack index or None) of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        s, g, i = _layer_places(cfg)[int(parts[1])]
        return "/".join([f"stages/{s}/pos{i}", *parts[2:]]), g
    if parts[0] == "encoder":
        return "/".join(["encoder/stages/0/pos0", *parts[2:]]), int(parts[1])
    return tsharding.path_str(name), None


_META = {}


def _meta_params(arch):
    if arch not in _META:
        _META[arch] = {n: p for n, p in TrainModel(tconfigs.get(arch), device="meta").named_parameters()}
    return _META[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_wanted_equals_jax_on_every_leaf(arch):
    """Each port leaf is a JAX leaf with its stack entry dropped: the same
    shape (the (in, out) layout, no transpose) and the same wanted axes."""
    cfg = tconfigs.get(arch)
    jshapes = _jax_param_shapes(arch)
    covered = {}
    for name, p in _meta_params(arch).items():
        assert p.device.type == "meta"
        jpath, index = _jax_name(cfg, name)
        jshape = jshapes[jpath]
        jw = jsharding.param_wanted(jpath, jshape)
        tw = _pw(name, tuple(p.shape))
        if index is None:
            assert tuple(p.shape) == jshape and tw == jw, (name, jpath)
        else:
            assert tuple(p.shape) == jshape[1:] and jw[0] is None and tw == jw[1:], (name, jpath)
            assert index < jshape[0]
        covered[jpath] = covered.get(jpath, 0) + 1
    # every JAX leaf is covered, once per stacked entry
    assert set(covered) == set(jshapes)
    for jpath, n in covered.items():
        assert n == (jshapes[jpath][0] if jpath.startswith(("stages/", "encoder/stages/")) else 1)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_tree_shardings_equal_jax_on_production_meshes(multi_pod):
    """Placements of every parameter of the ten configs on the production
    mesh: the port's tree_shardings against JAX's logical_spec (stub mesh)
    on the stacked JAX leaf, stack entry dropped, turned into placements."""
    world = 512 if multi_pod else 256
    jshape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    jmesh = _StubMesh(jshape)
    jrules = jdefault_rules(jmesh)
    with fake_process_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = default_rules(mesh)
        assert dataclasses.astuple(rules) == dataclasses.astuple(jrules)
        sharded = 0
        for arch in ARCHS:
            cfg = tconfigs.get(arch)
            params = _meta_params(arch)
            got = tsharding.tree_shardings(mesh, rules, params, tsharding.param_wanted)
            assert set(got) == set(params)
            jshapes = _jax_param_shapes(arch)
            for name, placements in got.items():
                jpath, index = _jax_name(cfg, name)
                spec = tuple(japi.logical_spec(jmesh, jrules, jshapes[jpath],
                                               jsharding.param_wanted(jpath, jshapes[jpath])))
                if index is not None:
                    assert spec[0] is None
                    spec = spec[1:]
                assert placements == tapi.to_placements(mesh, spec), (arch, name)
                sharded += any(type(pl).__name__ == "Shard" for pl in placements)
        assert sharded > 0
        repl = tsharding.replicated(mesh, {"a": torch.empty(3, device="meta")})
        assert all(type(pl).__name__ == "Replicate" for pl in repl["a"]) and len(repl["a"]) == len(jshape)


# --------------------------------------------------------- states and batches
@pytest.mark.parametrize("arch", ARCHS)
def test_state_and_batch_wanted_equal_jax(arch):
    from repro.launch.input_specs import input_specs as jinput_specs
    from repro_torch.launch.input_specs import input_specs as tinput_specs
    from repro_torch.models import Model

    jmodel = JModel(jconfigs.get(arch))
    tmodel = Model(tconfigs.get(arch), device="meta")
    cfg = tmodel.cfg
    js = jinput_specs(jmodel, "decode_32k")
    ts = tinput_specs(tmodel, "decode_32k")
    jstates = _jax_leaves(js["states"])
    places = _layer_places(cfg)
    n = 0
    for layer, st in enumerate(ts["states"]):
        s, g, i = places[layer]

        def walk(tree, keys):
            nonlocal n
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, keys + (k,))
                return
            jpath = "/".join([str(s), f"pos{i}", *keys])
            jshape = jstates[jpath]
            tpath = tsharding.path_str((layer, *keys))
            assert tuple(tree.shape) == jshape[1:] and g < jshape[0], (tpath, jpath)
            want = jsharding.state_wanted(jpath, jshape, tp_size=16)
            assert want[0] is None
            assert tsharding.state_wanted(tpath, tuple(tree.shape), tp_size=16) == want[1:], tpath
            n += 1

        walk(st, ())
    assert n == sum(jshape[0] for jshape in jstates.values())
    for shape_name in ("train_4k", "prefill_32k"):
        jb, tb = jinput_specs(jmodel, shape_name)["batch"], tinput_specs(tmodel, shape_name)["batch"]
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tsharding.batch_wanted(k, tuple(tb[k].shape)) == jsharding.batch_wanted(k, jb[k].shape)


# -------------------------------------------------------------- logical_spec
_MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
           ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model"))]
_RULES = [dict(), dict(sp="model"), dict(fsdp=None), dict(dp=("pod", "data"), fsdp=("pod", "data")),
          dict(tp=("data", "model"))]
_SHAPES = [(28, 64), (30, 64), (1, 5), (256, 4096, 3584), (3584, 18944), (64, 2, 16),
           (0, 8), (512, 1024, 7)]
_WANTED = [("tp", None), ("dp", None), ("fsdp", "tp"), ("dp", "sp", None), ("ep", "dp", None),
           (None, "fsdp", "tp"), ("tp", "fsdp", None)]


@pytest.mark.parametrize("mesh_shape,axes", _MESHES, ids=lambda v: "x".join(map(str, v)))
def test_logical_spec_equals_jax_over_a_grid(mesh_shape, axes):
    jmesh = _StubMesh(dict(zip(axes, mesh_shape)))
    with fake_process_group(int(np.prod(mesh_shape))):
        mesh = make_mesh(mesh_shape, axes)
        assert tapi.mesh_axes(mesh) == jmesh.shape
        checked = 0
        for kw in _RULES:
            base = {} if "model" in axes else {"tp": None, "ep": None}
            jr = japi.ShardingRules(**{**base, **kw})
            names = {a for v in dataclasses.astuple(jr) if v
                     for a in ((v,) if isinstance(v, str) else v)}
            if not names <= set(axes):
                continue
            tr = tapi.ShardingRules(**dataclasses.asdict(jr))
            for shape in _SHAPES:
                for wanted in _WANTED:
                    if len(wanted) != len(shape):
                        continue
                    want = tuple(japi.logical_spec(jmesh, jr, shape, wanted))
                    got = tapi.logical_spec(mesh, tr, shape, wanted)
                    assert got == want, (kw, shape, wanted)
                    used = [a for e in got if e for a in ((e,) if isinstance(e, str) else e)]
                    if len(used) == len(set(used)):
                        tapi.to_placements(mesh, got)
                    else:  # an axis on two dims: no sharding has that, in JAX either
                        with pytest.raises(ValueError):
                            tapi.to_placements(mesh, got)
                    checked += 1
        assert checked > 0


def test_logical_spec_divisibility_guard():
    """Dims that don't divide the axis product must replicate, not crash
    (the JAX test's cases)."""
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        rules = tapi.ShardingRules(dp=("data",), tp="model", fsdp=("data",))
        # 28 heads on a 4-way model axis -> sharded; 30 -> replicated
        assert tapi.logical_spec(mesh, rules, (28, 64), ("tp", None)) == ("model", None)
        assert tapi.logical_spec(mesh, rules, (30, 64), ("tp", None)) == (None, None)
        # batch 1 cannot shard over dp
        assert tapi.logical_spec(mesh, rules, (1, 5), ("dp", None)) == (None, None)


def test_to_placements_two_axes_on_one_dim():
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        assert tapi.to_placements(mesh, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
        assert tapi.to_placements(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
        with pytest.raises(ValueError):
            tapi.to_placements(mesh, (("data", "pod"), None))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("fsdp,sp", [(True, False), (False, True)])
def test_default_rules_equal_jax(multi_pod, fsdp, sp):
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.shape) == tuple(shape.values())
        assert tuple(mesh.mesh_dim_names) == tuple(shape)
        got = default_rules(mesh, fsdp=fsdp, sp=sp)
    assert dataclasses.astuple(got) == dataclasses.astuple(
        jdefault_rules(_StubMesh(shape), fsdp=fsdp, sp=sp))


def test_make_mesh_needs_a_matching_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((2,), ("data",))
    with fake_process_group(4):
        with pytest.raises(ValueError, match="needs 8 ranks"):
            make_mesh((2, 4), ("data", "model"))


# --------------------------------------------------------------- wire bytes
@pytest.mark.parametrize("method", ["fp32", "bf16", "int8", "topk"])
def test_wire_bytes_equal_jax(method):
    import jax.numpy as jnp

    for sizes in ([(1000,), (24,)], [(64, 64), (3, 5, 7)], [(3584, 18944)]):
        tt = {f"p{i}": torch.empty(s, device="meta") for i, s in enumerate(sizes)}
        jt = {f"p{i}": jax.ShapeDtypeStruct(s, jnp.float32) for i, s in enumerate(sizes)}
        for k in (0.01, 0.25):
            assert wire_bytes(tt, method, k) == jwire_bytes(jt, method, k)
    with pytest.raises(ValueError):
        wire_bytes(tt, "fp8")


def test_wire_bytes_model():
    tree = {"a": torch.zeros((1000,)), "b": torch.zeros((24,))}
    assert wire_bytes(tree, "fp32") == 2 * 4 * 1024
    assert wire_bytes(tree, "int8") < wire_bytes(tree, "bf16") < wire_bytes(tree, "fp32")
    assert wire_bytes(tree, "topk", 0.01) < wire_bytes(tree, "int8")


# ----------------------------------------------------------------- constrain
def test_constrain_is_a_no_op_outside_a_context():
    x = torch.randn(2, 8, 16)
    assert tapi.current_rules() is None
    assert tapi.constrain(x, ("dp", "sp", None)) is x
    assert tapi.constrain_first(x, ("dp", "tp", None), ("dp", None, None)) is x


def test_constrain_redistributes_dtensors_inside_a_context():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        x = torch.randn(4, 6, 8)
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with tapi.sharding_context(mesh, default_rules(mesh)):
            assert tapi.current_rules()[0] is mesh
            assert tapi.constrain(x, ("dp", None, None)) is x  # a plain tensor stays
            y = tapi.constrain(d, ("dp", "sp", None))  # sp off: only dp
            assert tuple(y.placements) == (Shard(0), Replicate())
            assert tuple(y.to_local().shape) == (2, 6, 8)
            z = tapi.constrain(d, ("dp", "tp", None))
            assert tuple(z.placements) == (Shard(0), Shard(1))
            assert tapi.constrain(z, ("dp", "tp", None)) is z  # already there
            # (5, 6, 8): dp does not divide 5; the second option is granted in full
            e = distribute_tensor(torch.randn(5, 6, 8), mesh, [Replicate(), Replicate()])
            w = tapi.constrain_first(e, ("dp", "tp", None), (None, "tp", None))
            assert tuple(w.placements) == (Replicate(), Shard(1))
        assert tapi.current_rules() is None


def test_model_forward_is_unchanged_by_the_constrain_calls():
    """The layer-input and MoE dispatch constraints are no-ops outside a
    context: a forward pass on plain tensors inside a context gives the
    same numbers as outside one."""
    from repro_torch.models import ExecConfig, Model

    cfg = tconfigs.get_tiny("moonshot_v1_16b_a3b")
    model = Model(cfg, ExecConfig(), device="cpu", seed=0)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 8)))
    h0 = model({"tokens": tokens})
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with tapi.sharding_context(mesh, default_rules(mesh)):
            h1 = model({"tokens": tokens})
    assert torch.equal(h0, h1)


# ------------------------------------------------------------- device pool
def test_device_pool_and_bound_measure():
    from repro_torch.core import ExecutableCache
    from repro_torch.parallel.devices import local_device_pool
    from repro_torch.tuning.fleet import device_bound_measure

    cache = ExecutableCache(maxsize=8)
    slots = local_device_pool(4, cache=cache)
    assert len(slots) == 4
    assert all(s.cache is not None for s in slots)
    # this host has no card: the pool's host mode, as the JAX pool's
    assert all(s.device is None and str(s) == f"slot{s.index}[host]" for s in slots)
    slots[0].cache.get_or_build("k", lambda: "a")
    assert slots[0].cache.peek("k") == "a"
    seen = []
    wrapped = device_bound_measure(lambda i, pts: seen.append(i) or [0.0] * len(pts), slots)
    assert wrapped(0, [np.zeros(2)]) == [0.0]
    assert seen == [0]
    assert device_bound_measure(len, []) is len
    with pytest.raises(ValueError):
        local_device_pool(0)


def test_bound_measure_pins_each_member_in_its_worker_thread():
    """A slot with a device enters ``torch.cuda.device`` in the thread that
    measures, so the measurement sees its slot's card as current there;
    with a stand-in for the context (per thread, as the card's is) the
    pinning is visible on the CPU."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.parallel.devices import DeviceSlot
    from repro_torch.tuning import fleet

    current = threading.local()

    class FakeCudaDevice:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            self.prev, current.dev = getattr(current, "dev", None), self.dev

        def __exit__(self, *exc):
            current.dev = self.prev
            return False

    slots = [DeviceSlot(i, torch.device("cuda", i % 2)) for i in range(4)]
    real = torch.cuda.device
    torch.cuda.device = FakeCudaDevice
    try:
        wrapped = fleet.device_bound_measure(
            lambda i, pts: [getattr(current, "dev", None)] * len(pts), slots)
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda i: wrapped(i, [0])[0], range(6)))
    finally:
        torch.cuda.device = real
    assert got == [slots[i % 4].device for i in range(6)]


def test_h100_spec_links_and_memory():
    from repro_torch.core.costs import H100_SXM, HardwareSpec

    assert H100_SXM.hbm_bytes == 80e9 and H100_SXM.links == 18
    assert H100_SXM.link_bw * H100_SXM.links * 2 == 900e9  # both ways
    # the roofline's fields and their meaning are unchanged
    assert (H100_SXM.peak_flops, H100_SXM.peak_flops_fp32, H100_SXM.hbm_bw) == (989e12, 67e12, 3.35e12)
    assert H100_SXM.peak_for("bfloat16") == 989e12 and H100_SXM.peak_for("float32") == 67e12
    spec = HardwareSpec("x", 1.0, 2.0, 3.0)  # the old positional form still builds
    assert (spec.link_bw, spec.links, spec.hbm_bytes) == (25e9, 18, 80e9)
