"""Each reference agrees with the program's plain path at the tiny configs
(computing in float32): the forward's logits, and the readings of three
training steps."""
import importlib

import pytest
import torch

from bench.harness import train, weights
from bench.harness.inputs import train_batch
from bench.harness.reference_runs import reference_logits
from bench.tests.tiny import tiny_cell

TRAIN = ["rwkv6_7b.train", "seamless_m4t_large_v2.train"]


@pytest.mark.parametrize("name", TRAIN)
def test_forward_logits(name):
    from repro_torch.models import ExecConfig, Model

    cell = tiny_cell(name)
    model = Model(train.program_config(cell), ExecConfig(interpret=True, rec_chunk=8),
                  device="cpu")
    weights.load_into(dict(model.named_parameters()), cell.reference().recipe(cell.sizes), 5)
    batch = train_batch(cell.sizes, cell.traffic, 9, 0, "cpu")
    want = model.logits(model(batch)).float()
    got = reference_logits(cell, 5, batch, "cpu")
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * want.abs().max())


@pytest.mark.parametrize("name", TRAIN)
def test_training_readings(name):
    """Three AdamW steps: the program's plain path and the reference read
    alike to float32 rounding."""
    cell = tiny_cell(name)
    run = train.build(cell, 21, "cpu")
    prog = train.first_steps(run, 3)
    numbers = train.compare(prog, train.reference(cell, 21, "cpu"))
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-4


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_departs(name):
    """The reference in fp8 reads far from the float32 one."""
    cell = tiny_cell(name)
    numbers = train.compare(train.reference(cell, 3, "cpu", "fp8"), train.reference(cell, 3, "cpu"))
    assert numbers["grad_gap"] > 1e-2


def test_recipes_cover_every_leaf_once():
    for name in TRAIN:
        cell = tiny_cell(name)
        names = weights.leaf_names(cell.reference().recipe(cell.sizes))
        assert len(names) == len(set(names))


def test_group_values_are_reproducible():
    cell = tiny_cell("rwkv6_7b.train")
    recipe = cell.reference().recipe(cell.sizes)
    a = weights.group_values(recipe, 2**33 + 1, 1, "cpu")
    b = weights.group_values(recipe, 2**33 + 1, 1, "cpu")
    c = weights.group_values(recipe, 2**33 + 2, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.tm.wr"], c["layers.0.tm.wr"])
    assert float(a["layers.0.tm.wr"].abs().max()) <= 2.0 / 64 ** 0.5 + 1e-6


def test_reference_imports():
    for mod in ("rwkv6_7b", "seamless_m4t_large_v2", "common"):
        importlib.import_module(f"bench.reference.{mod}")
