"""The Moonlight-16B-A3B serving cell at tiny sizes on the CPU: it loads by
name, its reference agrees with the program's plain path, a whole run is
``correct`` and reports the cell's new per-layer metrics, and at full depth
in fp32, where the program routes as the reference does and the sound
program reads 0, the shared experts left out and the fp8 control read
above the cell's own ``logit_gap`` limit.  The biased scores used as the
gates change each gate by a few per cent (the bias's scale, 0.05, against
chosen scores near 0.8): they read far above the sound program but under
the limit, here as at the cell's size (PERF.md §2); the router's own test
(``tests/test_torch_moonlight.py``) holds the gates to the unbiased
scores."""
import time

import pytest
import torch

from bench.harness import serve, weights
from bench.harness.cell_run import run_cell
from bench.harness.inputs import serve_batch
from bench.harness.moe_mla_work import grouped_experts_work, mla_flash_fwd_work
from bench.harness.reference_runs import reference_logits
from bench.harness.spec import load_cell, metric_reader
from bench.harness.train import program_config
from bench.tests.tiny import tiny_cell

CELL = "moonlight_16b_a3b.serve"
NEW_METRICS = ("moe_roofline.prefill", "mla_flash_roofline.prefill", "moe_ms.decode",
               "moe_idle_share.prefill", "expert_load_max.prefill")
#: the sizes of the tiny config that ``tiny_cell`` does not carry over
MLA_MOE_SIZES = ("kv_lora_rank", "qk_rope_dim", "n_experts", "top_k", "d_ff_expert",
                 "n_shared_experts", "routed_scale", "norm_eps", "rope_theta")


def moonlight_cell(compute_dtype: str = "float32", layers: int = 0, d_model: int = 0,
                   vocab: int = 0, **traffic):
    """The cell at the tiny config's sizes (``tiny_cell`` carries over the
    dense ones; the latent and expert sizes are added here); ``layers``
    (all but the first MoE), ``d_model`` (heads of 128 + 64, latent and
    expert widths d_model / 2) and ``vocab`` make it larger."""
    from repro_torch import configs

    cell = tiny_cell(CELL, compute_dtype, **traffic)
    cfg = configs.get_tiny("moonlight_16b_a3b")
    sizes = dict(cell.config["sizes"], first_dense_layers=len(cfg.lead),
                 **{k: getattr(cfg, k) for k in MLA_MOE_SIZES})
    overrides = dict(cell.config["port"]["overrides"])
    if layers or d_model or vocab:
        d = d_model or cfg.d_model
        grow = {"n_layers": layers or cfg.n_layers, "d_model": d, "n_heads": max(1, d // 64),
                "n_kv_heads": max(1, d // 64), "d_ff": 4 * d, "kv_lora_rank": d // 2,
                "d_ff_expert": d // 2, "vocab_size": vocab or cfg.vocab_size}
        sizes.update(grow, source_vocab_size=grow["vocab_size"])
        overrides.update(grow, n_groups=grow["n_layers"] - len(cfg.lead))
    cell.config = dict(cell.config, sizes=sizes, port=dict(cell.config["port"], overrides=overrides))
    return cell


def _run(cell, trace=False):
    return run_cell(cell, 2**32 + 3, 0.3, trace, "cpu", time.perf_counter())


def test_the_cell_loads_by_name():
    cell = load_cell(CELL)
    assert cell.workload["chips"] == 1 and cell.traffic["batch"] == 32
    assert cell.traffic["prompt_lens"] == [4096] and cell.traffic["gen"] == 256
    assert cell.sizes["padded_vocab"] == 163840 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"prefill_tokens_per_s",
                                                    "decode_tokens_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW_METRICS) <= names and "mfu.prefill" in names
    for m in cell.per_layer:
        metric_reader(m["name"])  # every reader exists
    assert set(cell.limits) == {"logit_gap"}


def test_program_config_matches_the_file_at_full_size():
    cell = load_cell(CELL)
    cfg = program_config(cell)
    for key in MLA_MOE_SIZES:
        assert getattr(cfg, key) == cell.sizes[key], key
    assert len(cfg.lead) == cell.sizes["first_dense_layers"]
    # the published config's keys, as the file carries them
    c = cell.config
    assert (c["kv_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"], c["v_head_dim"]) == (
        cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.d_head, cfg.d_head)
    assert (c["n_routed_experts"], c["num_experts_per_tok"], c["n_shared_experts"]) == (
        cfg.n_experts, cfg.top_k, cfg.n_shared_experts)
    assert c["routed_scaling_factor"] == cfg.routed_scale and c["rms_norm_eps"] == cfg.norm_eps


def test_reference_forward_matches_the_program():
    from repro_torch.models import ExecConfig, Model

    cell = moonlight_cell()
    model = Model(program_config(cell), ExecConfig(attn_impl="cuda", interpret=True),
                  device="cpu")
    weights.load_into(dict(model.named_parameters()), cell.reference().recipe(cell.sizes), 5)
    batch = serve_batch(cell.sizes, cell.traffic, 9, 0, 32, "cpu")
    want = model.logits(model({"tokens": batch["tokens"]})).float()
    got = reference_logits(cell, 5, {"tokens": batch["tokens"]}, "cpu")
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * want.abs().max())


def test_model_flops_count_the_published_prefill():
    """The published shapes' prefill: 662 TFLOP for 32 × 4096 prompt tokens (routed
    experts 354, attention 74)."""
    cell = load_cell(CELL)
    flops = cell.reference().model_flops(cell.sizes, batch=32, tokens=4096, last_only=True)
    assert 655e12 < flops < 670e12


def test_work_functions():
    f, kind, b = grouped_experts_work(786432, 2048, 1408, 64)
    assert kind == "bf16" and f == 6.0 * 786432 * 2048 * 1408
    assert b == 2 * (3 * 64 * 2048 * 1408 + 2 * 786432 * 2048)
    f, _, b = mla_flash_fwd_work(1, 1, 2, 192, 128)
    assert f == 2 * 3 * 320 and b == 2 * 2 * (384 + 256)


def test_sound_run_is_correct_and_reports_the_new_metrics():
    out = _run(moonlight_cell(), trace=True)
    assert out["correct"] is True, out["checks"]
    metrics = out["metrics"]
    # the CPU trace has no device kernels: the kernel readers find nothing
    for name in ("moe_roofline.prefill", "mla_flash_roofline.prefill", "moe_ms.decode"):
        assert name not in metrics
    assert metrics["expert_load_max.prefill"]["value"] >= 1.0
    assert 0.0 <= metrics["moe_idle_share.prefill"]["value"] <= 100.0
    assert metrics["mfu.prefill"]["value"] > 0


#: full depth at a narrow width and the full vocabulary, in fp32: the
#: program's routing is the reference's there, so the sound program reads
#: 0 and a planted fault reads what it changes
DEEP = {"layers": 27, "d_model": 128, "vocab": 163840, "batch": 4}


def _limit() -> float:
    return load_cell(CELL).limits["logit_gap"]


def _gap(cell) -> float:
    out = _run(cell)
    return out["checks"]["logit_gap"]["value"]


def _biased_gates(cfg, p, xt):
    """The fault: the gates formed from the biased scores."""
    scores = torch.sigmoid(xt.float() @ p["router"].float()) + p["router_bias"].float()
    eidx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    gate = scores.gather(1, eidx)
    return {"expert": eidx, "gate": gate / gate.sum(dim=-1, keepdim=True) * cfg.routed_scale}


def test_sound_program_reads_no_gap_where_routing_is_exact():
    assert _gap(moonlight_cell(**DEEP)) < 1e-3


def test_shared_experts_left_out(monkeypatch):
    import repro_torch.models.moe as moe

    ffn = moe.ffn_apply

    def without_shared(kind, p, x):
        return torch.zeros_like(ffn(kind, p, x))

    monkeypatch.setattr(moe, "ffn_apply", without_shared)
    assert _gap(moonlight_cell(**DEEP)) > _limit()


def test_biased_scores_used_as_gates(monkeypatch):
    """A hundred times the sound program's reading at this size, and under
    the cell's limit (see the module's docstring)."""
    import repro_torch.models.moe as moe

    monkeypatch.setattr(moe, "route_sigmoid", _biased_gates)
    assert _gap(moonlight_cell(**DEEP)) > 0.1


def test_the_control_departs():
    """The token the reference computed in fp8 puts first reads above the
    cell's limit, where the sound program reads 0."""
    cell = moonlight_cell(**DEEP)
    run = serve.build(cell, 4, "cpu")
    for i, P in enumerate(cell.traffic["prompt_lens"]):
        run.done.append(serve.serve_one(run, i, P, cell.traffic["gen"]))
    pairs = serve.sample(run, cell.traffic["sample"])
    serve.free(run)
    gaps = serve.gaps(run, pairs, ("fp8",))
    assert gaps["program"] < 1e-3 and gaps["fp8"] > _limit()


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_find_nothing_without_a_trace(name):
    import types

    ctx = types.SimpleNamespace(trace=None, traced=[], window={}, batches=[])
    value = metric_reader(name)(ctx)
    assert value is None or name == "expert_load_max.prefill"
