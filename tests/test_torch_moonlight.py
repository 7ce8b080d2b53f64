"""Moonlight-16B-A3B on the port's normal path, on the CPU at tiny sizes, in
fp32, against the plain reference ``bench/reference/moonlight_16b_a3b.py``:
the prefill's logits; prefill then absorbed-form decode steps against the
reference's full forward; the flash kernel's plain version at query/key
heads 192 and value heads 128; the sigmoid router; the drop-free grouped
dispatch above the capacity path's 8192 assignments; the serving launcher.
The JAX package has no such architecture: nothing here imports it."""
import dataclasses
import math

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch
import torch.nn.functional as F

from bench.harness import weights
from bench.reference import moonlight_16b_a3b as ref
from bench.reference.common import exact_matmuls
from repro_torch import configs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import ExecConfig, Model
from repro_torch.models import moe
from repro_torch.obs.metrics import registry

ARCH = "moonlight_16b_a3b"
SEED = 2**33 + 7


def _sizes(cfg) -> dict:
    """The reference's sizes of a config."""
    return {"n_layers": cfg.n_layers, "first_dense_layers": len(cfg.lead), "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "d_head": cfg.d_head, "qk_rope_dim": cfg.qk_rope_dim,
            "kv_lora_rank": cfg.kv_lora_rank, "d_ff": cfg.d_ff, "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "d_ff_expert": cfg.d_ff_expert,
            "n_shared_experts": cfg.n_shared_experts, "routed_scale": cfg.routed_scale,
            "router_bias_scale": 0.05, "norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "padded_vocab": cfg.padded_vocab}


def _model(attn_impl="cuda"):
    """The tiny config in fp32 with the reference's weights (router bias
    included); ``attn_impl="cuda"`` runs the kernels' plain versions."""
    cfg = dataclasses.replace(configs.get_tiny(ARCH), compute_dtype="float32")
    model = Model(cfg, ExecConfig(attn_impl=attn_impl, interpret=True), device="cpu")
    sizes = _sizes(cfg)
    recipe = ref.recipe(sizes)
    weights.load_into(dict(model.named_parameters()), recipe, SEED)
    return model, sizes, recipe


def _ref_logits(sizes, recipe, tokens):
    index = {g: i for i, (g, _) in enumerate(recipe)}
    with exact_matmuls():
        return ref.forward(lambda g: weights.group_values(recipe, SEED, index[g], "cpu"),
                           {"tokens": tokens}, sizes)


def _tokens(B, S, seed=1):
    return torch.randint(0, 512, (B, S), generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------------ configuration
def test_registry_finds_moonlight_beside_the_jax_architectures():
    cfg = configs.get(ARCH)
    assert configs.get("moonlight-16b-a3b") == cfg and configs.get_tiny(ARCH).lead == ("mla_dense",)
    assert ARCH not in configs.ARCH_IDS and len(configs.ARCH_IDS) == 10
    assert ARCH not in configs.ALIASES.values() and ARCH in configs.EXTRA_ARCH_IDS
    assert cfg.pattern == ("mla_dense",) + ("mla",) * 26
    assert (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.qk_rope_dim, cfg.kv_lora_rank) == (
        2048, 16, 128, 64, 512)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.n_shared_experts, cfg.d_ff) == (
        64, 6, 1408, 2, 11264)
    assert cfg.router == "sigmoid" and cfg.routed_scale == 2.446 and cfg.norm_eps == 1e-5
    assert abs(cfg.param_count() - 15.96e9) < 0.01e9
    # the JAX package's fields read as switched off on a plain ModelConfig
    plain = configs.get("moonshot_v1_16b_a3b")
    assert (plain.lead, plain.kv_lora_rank, plain.n_shared_experts, plain.router) == (
        (), 0, 0, "softmax")


def test_latent_cache_holds_576_bf16_values_a_token_and_layer():
    model = Model(configs.get(ARCH), device="meta")
    states = model.init_states(32, 4352, "prefill")
    assert len(states) == 27
    for st in states:
        assert tuple(st["kv"]["kv"].shape) == (32, 4352, 576)
        assert st["kv"]["kv"].dtype == torch.bfloat16 and set(st["kv"]) == {"kv", "pos"}
        assert st["kv"]["kv"][0, 0].numel() * st["kv"]["kv"].element_size() == 1152


# ------------------------------------------------------- model vs reference
def test_prefill_logits_match_the_reference():
    model, sizes, recipe = _model()
    tokens = _tokens(2, 20)  # padded to 64 for the flash kernel
    with torch.no_grad():
        got = model.logits(model({"tokens": tokens})).float()
        hidden, _ = model.prefill({"tokens": tokens, "max_len": 28})
        last = model.logits(hidden[:, None])[:, 0].float()
    want = _ref_logits(sizes, recipe, tokens)
    _close(got, want)
    _close(last, want[:, -1])


def test_prefill_then_absorbed_decode_matches_the_reference():
    """Eight decode steps in the absorbed form over the latent cache,
    against the reference's naive full forward over prompt + tokens."""
    model, sizes, recipe = _model()
    P, n = 20, 8
    tokens = _tokens(2, P, seed=3)
    with torch.no_grad():
        hidden, states = model.prefill({"tokens": tokens, "max_len": P + n})
        logits = [model.logits(hidden[:, None])[:, 0]]
        seq = tokens
        for i in range(n):
            tok = logits[-1].argmax(-1)[:, None]
            seq = torch.cat([seq, tok], dim=1)
            lg, states = model.decode_step(tok, states, torch.tensor(P + i))
            logits.append(lg)
    want = _ref_logits(sizes, recipe, seq)[:, P - 1:]
    _close(torch.stack(logits, dim=1).float(), want)


def test_plain_attention_path_matches_the_kernel_path():
    """Without the kernel option the naive form runs through ``_sdpa``."""
    kernel, _, _ = _model("cuda")
    plain, _, _ = _model("xla")
    tokens = _tokens(1, 16, seed=5)
    with torch.no_grad():
        _close(plain({"tokens": tokens}), kernel({"tokens": tokens}))


def test_prefill_spans_and_expert_counters():
    from torch.profiler import ProfilerActivity, profile

    model, _, _ = _model()
    registry().reset()
    tokens = _tokens(2, 16, seed=6)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model.prefill({"tokens": tokens, "max_len": 16})
    names = {e.key for e in prof.key_averages()}
    assert {"mla.prefill", "moe.route", "moe.experts", "moe.combine"} <= names
    snap = registry().snapshot()
    loads = {k: v for k, v in snap.items() if k.startswith(moe.LOAD_COUNTER + ".")}
    assert sorted(loads) == [f"{moe.LOAD_COUNTER}.{i}" for i in (1, 2)]  # the MoE layers
    for v in loads.values():
        assert len(v) == 8 and sum(v) == 2 * 16 * 3  # every assignment counted once


# --------------------------------------------------------- flash at 192/128
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_latent_widths_matches_plain_attention(causal):
    B, H, S = 2, 3, 64
    g = torch.Generator().manual_seed(11)
    q = torch.randn(B, S, H, 192, generator=g)
    k = torch.randn(B, S, H, 192, generator=g).transpose(1, 2)
    v = torch.randn(B, S, H, 256, generator=g)[..., 128:].transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=causal, block_q=32, block_kv=16, interpret=True)
    assert got.shape == (B, S, H, 128)
    s = torch.einsum("bqhd,bhkd->bhqk", q, k) / math.sqrt(192)
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bhkd->bqhd", torch.softmax(s, dim=-1), v)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_flash_design_takes_latent_widths_on_the_tensor_cores_only():
    assert tfa.design(2, 192, 128, 128, hd_v=128) == "wgmma"
    assert tfa.ring_stages(192, 128, 128, 128) == 2 and tfa.ring_stages(192, 64, 64, 128) == 4
    assert tfa.ring_smem_bytes(192, 128, 128, 2, 128) == 214056
    assert tfa.design(4, 192, 128, 128, hd_v=128) == "simt"
    with pytest.raises(ValueError, match="tensor-core"):
        tfa.check_blocks(192, 128, 128, 4, hd_v=128)
    with pytest.raises(ValueError, match="not instantiated"):
        tfa.check_blocks(192, 64, 64, 2, hd_v=64)
    with pytest.raises(ValueError, match="no backward"):
        q = torch.zeros(1, 64, 1, 192, requires_grad=True)
        ops.flash_attention(q, q.transpose(1, 2), torch.zeros(1, 1, 64, 128), interpret=True)
    q = torch.zeros(1, 8, 2, 192, dtype=torch.bfloat16, device="meta").transpose(1, 2)
    flops, nbytes = tfa.flops_bytes(q, q, torch.zeros(1, 2, 8, 128, device="meta"), causal=True)
    assert flops == 2.0 * 2 * 36 * 320 and nbytes == 2 * 2 * 8 * (192 * 2 + 128 * 2)


# ------------------------------------------------------------------- router
def _router_params(E=8, d=16, bias_scale=0.05, seed=12):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(d, E, generator=g) / math.sqrt(d),
            "router_bias": torch.randn(E, generator=g) * bias_scale}


def test_router_bias_moves_selection_but_not_the_gates():
    cfg = configs.get_tiny(ARCH)
    p = _router_params(bias_scale=0.2)
    x = torch.randn(512, 16, generator=torch.Generator().manual_seed(13))
    r = moe.route_sigmoid(cfg, p, x)
    unbiased = moe.route_sigmoid(cfg, dict(p, router_bias=torch.zeros(8)), x)
    moved = (torch.sort(r["expert"], 1).values != torch.sort(unbiased["expert"], 1).values).any(1)
    assert 0 < int(moved.sum()) < 512  # the bias changes some selections
    scores = torch.sigmoid(x @ p["router"])
    chosen = scores.gather(1, r["expert"])
    torch.testing.assert_close(r["gate"], chosen / chosen.sum(1, keepdim=True) * 2.446)
    torch.testing.assert_close(r["gate"].sum(1), torch.full((512,), 2.446))
    # the gates of tokens whose selection the bias leaves alone are the unbiased ones
    same = ~moved
    torch.testing.assert_close(torch.sort(r["gate"][same], 1).values,
                               torch.sort(unbiased["gate"][same], 1).values)


def test_router_breaks_ties_toward_the_lower_expert_index():
    cfg = configs.get_tiny(ARCH)  # 8 experts, top 3
    p = {"router": torch.zeros(16, 8), "router_bias": torch.zeros(8)}
    r = moe.route_sigmoid(cfg, p, torch.randn(5, 16))
    assert r["expert"].tolist() == [[0, 1, 2]] * 5
    p["router_bias"] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.1, 0.0])
    r = moe.route_sigmoid(cfg, p, torch.randn(2, 16))
    assert r["expert"].tolist() == [[4, 6, 0]] * 2
    torch.testing.assert_close(r["gate"], torch.full((2, 3), 2.446 / 3))


# --------------------------------------------------------- grouped dispatch
def test_grouped_dispatch_matches_a_per_token_loop_with_nothing_dropped():
    """1500 tokens × top 6 = 9000 assignments (above the capacity path's
    8192), skewed loads and an expert that gets no token: every
    assignment's output, the layer's output with gates and shared experts,
    and the counter of assignments."""
    cfg = dataclasses.replace(configs.get_tiny(ARCH), n_experts=16, top_k=6, d_model=32,
                              d_ff_expert=24, compute_dtype="float32")
    E, K, D, Fe = 16, 6, 32, 24
    g = torch.Generator().manual_seed(14)
    p = {"router": torch.randn(D, E, generator=g) / math.sqrt(D),
         "router_bias": torch.zeros(E),
         "wi": torch.randn(E, D, Fe, generator=g) / math.sqrt(D),
         "wg": torch.randn(E, D, Fe, generator=g) / math.sqrt(D),
         "wo": torch.randn(E, Fe, D, generator=g) / math.sqrt(Fe),
         "shared": {n: torch.randn(s, generator=g) / math.sqrt(s[0])
                    for n, s in (("wi", (D, 2 * Fe)), ("wg", (D, 2 * Fe)), ("wo", (2 * Fe, D)))}}
    p["router_bias"][5] = -10.0  # expert 5 gets no token
    p["router_bias"][0] = 2.0  # expert 0 every one
    x = torch.randn(3, 500, D, generator=g)
    registry().reset()
    y, aux = moe.moe_apply(cfg, p, x, layer=7)
    xt = x.reshape(-1, D)
    r = moe.route_sigmoid(cfg, p, xt)
    counts = torch.bincount(r["expert"].reshape(-1), minlength=E)
    assert counts[5] == 0 and counts[0] == 1500 and counts.sum() == 9000 and counts.max() > 2 * counts[1:].float().mean()
    assert registry().snapshot()[f"{moe.LOAD_COUNTER}.7"] == counts.tolist()
    want = torch.zeros_like(xt)
    each = moe.grouped_experts(p, xt, r["expert"], E)
    for t in range(xt.shape[0]):
        for k in range(K):
            e = int(r["expert"][t, k])
            out = (F.silu(xt[t] @ p["wg"][e]) * (xt[t] @ p["wi"][e])) @ p["wo"][e]
            torch.testing.assert_close(each[t, k], out, atol=1e-5, rtol=1e-5)
            want[t] += r["gate"][t, k] * out
    sh = p["shared"]
    want += (F.silu(xt @ sh["wg"]) * (xt @ sh["wi"])) @ sh["wo"]
    torch.testing.assert_close(y.reshape(-1, D), want, atol=1e-5, rtol=1e-5)
    assert float(aux) == 0.0


def test_capacity_path_configs_keep_their_parameters():
    """The softmax router's configs get no bias and no shared experts."""
    for arch in ("moonshot_v1_16b_a3b", "arctic_480b"):
        names = {n for n, _ in Model(configs.get_tiny(arch), device="meta").named_parameters()}
        assert not any("router_bias" in n or ".shared." in n for n in names)


# ------------------------------------------------------------------ launcher
def test_serve_launcher_runs_moonlight_tiny_on_the_cpu():
    from repro_torch.launch.serve import serve

    out = serve(["--arch", ARCH, "--tiny", "--device", "cpu", "--prompt-len", "20", "--gen", "16",
                 "--batch", "2"])
    assert out["decode_tok_s"] > 0 and out["hidden"].shape == (2, 64)
    assert out["model"].cfg.kv_lora_rank == 32


def test_device_counter_sums_and_starts_over_for_another_shape():
    from repro_torch.obs.metrics import DeviceCounter

    c = DeviceCounter()
    assert c.snapshot() is None
    c.add(torch.tensor([1, 2, 3]))
    c.add(torch.tensor([1, 0, 1]))
    assert c.snapshot() == [2, 2, 4]
    c.add(torch.tensor([5, 5]))  # another model's layer of 2 experts
    assert c.snapshot() == [5, 5]
