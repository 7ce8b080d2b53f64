"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports ``jax`` or the JAX package ``repro`` — checked by
reading every module's AST, and by importing the port in a subprocess where
both are blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [f"{path.name}:{ln}: {mod}" for ln, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
import numpy as np, torch
import repro_torch, repro_torch.core, repro_torch.obs, repro_torch.testing
import repro_torch.kernels, repro_torch.kernels.autotuned, repro_torch.kernels.ops
import repro_torch.tuning, repro_torch.tuning.pretune, repro_torch.tuning.fleet
import repro_torch.configs, repro_torch.models, repro_torch.models.convert, repro_torch.runtime
import repro_torch.core.strategy, repro_torch.core.grid_random, repro_torch.obs.report
import repro_torch.tune, repro_torch.kernels.decode_attention
import repro_torch.data, repro_torch.optim, repro_torch.train, repro_torch.checkpoint
import repro_torch.core.tuned_jit, repro_torch.runtime.driver, repro_torch.models.moe
import repro_torch.parallel, repro_torch.parallel.api, repro_torch.parallel.sharding
import repro_torch.parallel.collectives, repro_torch.parallel.pipeline, repro_torch.parallel.devices
import repro_torch.launch.mesh, repro_torch.launch.input_specs, repro_torch.launch.spaces
import repro_torch.launch.costing, repro_torch.launch.dryrun, repro_torch.launch.hillclimb
from repro_torch.launch import dryrun, serve, train
from repro_torch.launch.spaces import tune_launch
launch_rec = tune_launch("qwen2_7b", "train_4k", 8, max_iter=2, warm_start=False)
assert launch_rec is not None and launch_rec.key.backend == "model"
cell = dryrun.run_cell("rwkv6_7b", "train_4k", tiny=True, mesh_spec=((2, 2), ("data", "model")),
                       verbose=False)
assert cell["status"] == "ok" and cell["roofline"]["flops"] > 0
# the attention's bf16 product form on meta DTensors, counted pointwise too
cell = dryrun.run_cell("qwen2_7b", "train_4k", tiny=True, mesh_spec=((2, 2), ("data", "model")),
                       verbose=False)
assert cell["status"] == "ok" and cell["roofline"]["flops"] > 0
from repro_torch.kernels import autotuned, kernel_router, routed, tune_call
from repro_torch.tuning import TuningDB
a = torch.from_numpy(np.random.RandomState(0).standard_normal((64, 64)).astype(np.float32))
rec = tune_call("matmul", a, a, db=TuningDB(None), interpret=True, max_iter=1, jobs=1,
                strategy="csa+nm")
autotuned("matmul", a, a, interpret=True, db=TuningDB(None))
router = kernel_router(interpret=True, db=TuningDB(None), fresh=True)
q, kv = a[:2].reshape(2, 4, 16), a.reshape(2, 2, 64, 16)
out = routed("decode_attention", q, kv, kv, torch.ones(2, 64, dtype=torch.int32), router=router,
             interpret=True)
assert out.shape == (2, 4, 16) and router.stats()["calls"] == 1
served = serve.serve(["--arch", "rwkv6_7b", "--tiny", "--device", "cpu", "--prompt-len", "4",
                      "--gen", "2"])
assert served["hidden"].shape == (8, 64)
served = serve.serve(["--arch", "seamless_m4t_large_v2", "--tiny", "--device", "cpu",
                      "--prompt-len", "4", "--gen", "2"])
assert served["hidden"].shape == (8, 64)
for arch in ("qwen2_7b", "seamless_m4t_large_v2", "moonshot_v1_16b_a3b"):
    trained = train.train(["--arch", arch, "--tiny", "--device", "cpu", "--steps", "2",
                           "--global-batch", "2", "--seq-len", "8"])
    assert trained["steps"] == 2
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print("isolated-ok", rec.point)
"""


def test_port_imports_and_tunes_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "isolated-ok" in proc.stdout
