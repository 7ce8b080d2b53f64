"""``correct`` comes out false when the timed path is broken underneath, and
for the control: a whole run at tiny sizes on the CPU (the look for a card
skipped), with the program's step or decode patched, against the cells'
own limits."""
import time

import pytest
import torch

from bench.harness import serve, train
from bench.harness.cell_run import checks, run_cell
from bench.harness.spec import load_cell
from bench.tests.tiny import tiny_cell

TRAIN = ["rwkv6_7b.train", "seamless_m4t_large_v2.train"]
SERVE = ["rwkv6_7b.serve", "seamless_m4t_large_v2.serve"]


def _run(name):
    return run_cell(tiny_cell(name), 2**32 + 3, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from repro_torch.optim import AdamW

    def unchanged(self, grads, state, params):
        zero = torch.zeros(())
        return params, state, {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(AdamW, "update", unchanged)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name, suffix", [("rwkv6_7b.train", "tm.wr"),
                                          ("rwkv6_7b.train", "lm_head.w"),
                                          ("seamless_m4t_large_v2.train", "lm_head.w")])
def test_optimizer_that_leaves_some_leaves_unmoved(name, suffix, monkeypatch):
    """AdamW keeps every leaf's moments but writes no update to the leaves
    whose names end in ``suffix``."""
    from repro_torch.optim import AdamW

    update = AdamW.update

    def skipping(self, grads, state, params):
        kept = {k: p.clone() for k, p in params.items() if k.endswith(suffix)}
        out = update(self, grads, state, params)
        with torch.no_grad():
            for k, p in kept.items():
                params[k].copy_(p)
        return out

    monkeypatch.setattr(AdamW, "update", skipping)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name, monkeypatch):
    """The loss's mean over half the batch (half the positions of one row)."""
    import repro_torch.train.step as step

    make = step.make_loss_fn

    def half(model, **kw):
        fn = make(model, **kw)

        def loss_fn(params, batch):
            labels = batch["labels"].clone()
            B, S = labels.shape
            if B > 1:
                labels[B - B // 2:] = -1
            else:
                labels[:, S // 2:] = -1
            return fn(params, dict(batch, labels=labels))
        return loss_fn

    monkeypatch.setattr(step, "make_loss_fn", half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", SERVE)
def test_token_altered_where_it_is_produced(name, monkeypatch):
    from repro_torch.models.model import Model

    decode = Model.decode_step

    def altered(self, token, states, pos):
        logits, states = decode(self, token, states, pos)
        logits = logits.clone()
        logits[:, 1] = logits.max() + 1.0  # token 1 wins every decode step
        return logits, states

    monkeypatch.setattr(Model, "decode_step", altered)
    assert _run(name)["correct"] is False


def test_decode_that_leaves_the_state_unchanged(monkeypatch):
    """RWKV-6's recurrent state is returned, not written in place: a step
    that hands back its input state serves tokens the reference does not
    put first."""
    from repro_torch.models.model import Model

    decode = Model.decode_step

    def stale(self, token, states, pos):
        return decode(self, token, states, pos)[0], states

    monkeypatch.setattr(Model, "decode_step", stale)
    assert _run("rwkv6_7b.serve")["correct"] is False


#: sizes at which the control's readings reach the cells' limits on the CPU
#: (the limits are set at the cells' own sizes; depth and width raise the
#: control's gaps toward them)
CONTROL_SIZES = {"rwkv6_7b.train": {"layers": 4, "d_model": 256},
                 "seamless_m4t_large_v2.train": {"layers": 4, "d_model": 256},
                 "rwkv6_7b.serve": {"layers": 16, "d_model": 256, "vocab": 65536},
                 "seamless_m4t_large_v2.serve": {"layers": 8, "d_model": 256, "vocab": 65536}}


@pytest.mark.parametrize("name", [n for n in TRAIN if load_cell(n).limits])
def test_control_fails_a_training_limit(name):
    """The reference computed in fp8, put in the program's place."""
    cell = tiny_cell(name, **CONTROL_SIZES[name])
    numbers = train.compare(train.reference(cell, 4, "cpu", "fp8"), train.reference(cell, 4, "cpu"))
    compared = checks(numbers, cell.limits)
    assert any(c["value"] > c["limit"] for c in compared.values())


@pytest.mark.parametrize("name", SERVE)
def test_control_fails_the_serving_limit(name):
    """The token the reference computed in fp8 puts first, against the
    served ones (the program computing in bf16, as the cell runs it)."""
    cell = tiny_cell(name, "bfloat16", **CONTROL_SIZES[name])
    run = serve.build(cell, 4, "cpu")
    for i, P in enumerate(cell.traffic["prompt_lens"]):
        run.done.append(serve.serve_one(run, i, P, cell.traffic["gen"]))
    pairs = serve.sample(run, cell.traffic["sample"])
    serve.free(run)
    gaps = serve.gaps(run, pairs, ("fp8",))
    assert gaps["fp8"] > cell.limits["logit_gap"] >= gaps["program"]
