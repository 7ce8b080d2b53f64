"""The tile rules of the port's tensor-core (``wgmma``) kernels, on the CPU.

``matmul.design`` and ``flash_attention.design`` choose, before any launch,
which CUDA kernel runs a call: the TMA-fed ``wgmma`` kernel or the SIMT one.
These tests hold both functions to their rules (dtype, tile, head dim,
strides, alignment), check that the defaults at the qwen2-7b shapes take the
tensor cores, account the ring's shared memory against the block's 232,448
bytes, keep the search spaces equal to the JAX package's, and check that the
build key of every kernel library covers the shared header.  None of this
needs ``nvcc`` or a card.
"""
import shutil
from importlib import import_module

import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels.autotuned import classify_failure

jat = import_module("repro.kernels.autotuned")
tat = import_module("repro_torch.kernels.autotuned")
SMEM_LIMIT = 232448  # bytes a Hopper block may use


# ------------------------------------------------------------------ matmul
@pytest.mark.parametrize("bm,bn,bk,itemsize,aligned,want", [
    (128, 256, 64, 2, True, "wgmma"),  # the default tile
    (128, 128, 32, 2, True, "wgmma"),
    (64, 16, 16, 2, True, "wgmma"),  # the narrowest swizzle (32 bytes)
    (256, 128, 128, 2, True, "wgmma"),  # two 64-row slices per consumer warpgroup
    (128, 256, 64, 4, True, "simt"),  # fp32 never takes the tensor cores
    (64, 64, 64, 4, True, "simt"),
    (32, 128, 32, 2, True, "simt"),  # bm not a multiple of 64
    (128, 48, 32, 2, True, "simt"),  # bn not a power of two
    (128, 512, 32, 2, True, "simt"),  # bn over 256
    (128, 128, 8, 2, True, "simt"),  # bk under 16
    (128, 128, 40, 2, True, "simt"),  # bk not a whole swizzle row
    (128, 64, 48, 2, True, "simt"),
    (128, 64, 96, 2, True, "simt"),
    (128, 64, 192, 2, True, "wgmma"),  # three 128-byte rows
    (256, 256, 64, 2, True, "simt"),  # 256 accumulators a thread
    (128, 256, 256, 2, True, "simt"),  # one stage of 192 KB: no ring
    (128, 256, 64, 2, False, "simt"),  # an operand off a 16-byte boundary (TMA)
])
def test_matmul_design(bm, bn, bk, itemsize, aligned, want):
    assert tmm.design(bm, bn, bk, itemsize, aligned) == want


def test_matmul_fp32_never_takes_wgmma():
    for bm in (32, 64, 128, 256):
        for bn in (16, 32, 64, 128, 256):
            for bk in (16, 32, 64, 128, 256):
                assert tmm.design(bm, bn, bk, 4) == "simt"


@pytest.mark.parametrize("bm,bn,bk,stages,smem", [
    (128, 256, 64, 4, 197696),
    (128, 128, 32, 8, 132224),
    (128, 128, 128, 3, 197680),
    (64, 256, 128, 2, 164896),
    (64, 16, 16, 8, 25728),  # each tile rounds up to the swizzle's 1024 bytes
])
def test_matmul_ring_accounting(bm, bn, bk, stages, smem):
    assert tmm.ring_stages(bm, bn, bk) == stages
    assert tmm.ring_smem_bytes(bm, bn, bk, stages) == smem <= SMEM_LIMIT
    if stages < tmm.MAX_STAGES:  # one more stage would not fit
        assert tmm.ring_smem_bytes(bm, bn, bk, stages + 1) > SMEM_LIMIT


def test_every_wgmma_matmul_tile_of_the_space_fits_a_block():
    for bm in (64, 128, 256):
        for bn in (32, 64, 128, 256):
            for bk in (32, 64, 128, 256):
                if tmm.design(bm, bn, bk, 2) == "wgmma":
                    stages = tmm.ring_stages(bm, bn, bk)
                    assert 2 <= stages <= tmm.MAX_STAGES
                    assert tmm.ring_smem_bytes(bm, bn, bk, stages) <= SMEM_LIMIT


def test_matmul_check_tiles_names_the_design_and_refuses_what_neither_runs():
    assert tmm.check_tiles(128, 256, 64, itemsize=2) == "wgmma"
    assert tmm.check_tiles(128, 128, 32, itemsize=4) == "simt"
    assert tmm.check_tiles(32, 64, 32, itemsize=2) == "simt"
    with pytest.raises(ValueError, match="accumulators") as e:
        tmm.check_tiles(256, 256, 64, itemsize=2)  # wgmma: 256 accumulators; SIMT: 4096 threads
    assert classify_failure(e.value) == "illegal"


@pytest.mark.parametrize("M,N,K,itemsize,aligned,want", [
    (4096, 18944, 3584, 2, True, (128, 256, 64)),  # qwen2-7b FFN: the tensor-core tile
    (64, 128, 32, 2, True, (64, 128, 32)),  # clamped to the dims, still wgmma
    (256, 512, 512, 4, True, (128, 128, 32)),  # fp32: 128/256 would need 2048 SIMT threads
    (256, 384, 512, 2, True, (128, 128, 32)),  # N a multiple of 128, not of 256
    (256, 512, 96, 2, True, (128, 128, 32)),  # K a multiple of 32, not of 64
    (4096, 18944, 3584, 2, False, (128, 128, 32)),  # an operand off a 16-byte boundary
    (32, 64, 16, 4, True, (32, 64, 16)),
])
def test_matmul_default_tiles_run_on_the_card(M, N, K, itemsize, aligned, want):
    tiles = tmm.default_tiles(M, N, K, itemsize, aligned)
    assert tiles == want
    assert tmm.legal_tiles(M, N, K, *tiles, itemsize, on_card=True, aligned=aligned) == tiles


@pytest.mark.parametrize("dtype,M,K,N,want", [
    (torch.float32, 256, 512, 512, (128, 128, 32)),
    (torch.float32, 4096, 3584, 18944, (128, 128, 32)),
    (torch.float32, 256, 96, 384, (128, 128, 32)),
    (torch.bfloat16, 256, 512, 512, (128, 256, 64)),
    (torch.bfloat16, 4096, 3584, 18944, (128, 256, 64)),
    # the registry clamps to the largest power-of-two divisor of each dim
    (torch.bfloat16, 256, 512, 384, (128, 128, 64)),
    (torch.bfloat16, 256, 96, 512, (128, 256, 32)),
])
def test_matmul_registry_defaults_pass_the_registry_check(dtype, M, K, N, want):
    a = torch.empty(M, K, dtype=dtype, device="meta")
    b = torch.empty(K, N, dtype=dtype, device="meta")
    spec = tat.get_spec("matmul")
    knobs = spec.defaults(a, b)
    assert knobs == dict(zip(("bm", "bn", "bk"), want))
    spec.check(a, b, **knobs, interpret=False)  # raises for tiles the card cannot run


def test_matmul_check_sees_a_misaligned_operand():
    buf = torch.zeros(256 * 512 + 1, dtype=torch.bfloat16)
    a = buf[1:].view(256, 512)  # contiguous, 2 bytes past a 16-byte boundary
    b = torch.zeros(512, 512, dtype=torch.bfloat16)
    assert a.is_contiguous() and not tmm.aligned(a, b) and tmm.aligned(b, b)
    spec = tat.get_spec("matmul")
    with pytest.raises(ValueError, match="accumulators") as e:
        spec.check(a, b, bm=128, bn=256, bk=64, interpret=False)  # SIMT would need 2048 threads
    assert classify_failure(e.value) == "illegal"
    spec.check(b, b, bm=128, bn=256, bk=64, interpret=False)
    knobs = spec.defaults(a, b)
    assert knobs == {"bm": 128, "bn": 128, "bk": 32}
    spec.check(a, b, **knobs, interpret=False)


def test_matmul_without_knobs_runs_the_default_tile():
    a = torch.randn(256, 96)
    b = torch.randn(96, 384)
    want = tmm.matmul_plain(a, b, bm=128, bn=128, bk=32)
    assert torch.equal(tmm.matmul_tiled(a, b, interpret=True), want)
    assert torch.equal(tmm.matmul_tiled(a, b, bk=32, interpret=True), want)


# --------------------------------------------------------- flash attention
QWEN_Q_STRIDES = (2048 * 28 * 128, 128, 28 * 128)  # (B, H, Sq) of the (B, Sq, H, hd) view
QWEN_KV_STRIDES = (4 * 2048 * 128, 2048 * 128, 128)
QWEN_STRIDES = QWEN_Q_STRIDES + QWEN_KV_STRIDES * 2 + QWEN_Q_STRIDES


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("block_q", tfa.WGMMA_BLOCK_Q)
@pytest.mark.parametrize("block_kv", tfa.WGMMA_BLOCK_KV)
def test_flash_wgmma_takes_every_instantiated_tile(hd, block_q, block_kv):
    assert tfa.design(2, hd, block_q, block_kv) == "wgmma"
    assert tfa.design(4, hd, block_q, block_kv) == "simt"  # fp32 never
    stages = tfa.ring_stages(hd, block_q, block_kv)
    assert stages >= 2 and tfa.ring_smem_bytes(hd, block_q, block_kv, stages) <= SMEM_LIMIT
    # legal_blocks checks without the strides: a call TMA cannot describe
    # runs SIMT at the same tile, so SIMT must run every wgmma tile too
    assert tfa.check_blocks(hd, block_q, block_kv, 2, aligned=False) == "simt"


@pytest.mark.parametrize("itemsize,hd,block_q,block_kv,strides,aligned,want", [
    (2, 128, 128, 128, QWEN_STRIDES, True, "wgmma"),  # qwen2-7b prefill, transposed q
    (2, 128, 64, 64, QWEN_STRIDES, True, "wgmma"),
    (2, 128, 16, 128, (), True, "simt"),  # block_q not 64 or 128
    (2, 128, 256, 64, (), True, "simt"),
    (2, 128, 128, 256, (), True, "simt"),  # block_kv over what registers hold
    (2, 64, 64, 48, (), True, "simt"),  # block_kv not instantiated
    (2, 256, 128, 128, (), True, "simt"),  # head dim not instantiated
    (2, 64, 64, 64, (64 * 3 + 4,), True, "simt"),  # a stride TMA cannot describe
    (2, 64, 64, 64, (), False, "simt"),  # a tensor off a 16-byte boundary
])
def test_flash_design(itemsize, hd, block_q, block_kv, strides, aligned, want):
    assert tfa.design(itemsize, hd, block_q, block_kv, strides, aligned) == want


@pytest.mark.parametrize("hd,block_q,block_kv,stages,smem", [
    (128, 128, 128, 3, 230456),
    (128, 128, 64, 4, 164936),
    (128, 64, 128, 3, 214072),
    (16, 64, 16, 4, 11336),
])
def test_flash_ring_accounting(hd, block_q, block_kv, stages, smem):
    assert tfa.ring_stages(hd, block_q, block_kv) == stages
    assert tfa.ring_smem_bytes(hd, block_q, block_kv, stages) == smem <= SMEM_LIMIT
    if stages < tfa.MAX_STAGES:
        assert tfa.ring_smem_bytes(hd, block_q, block_kv, stages + 1) > SMEM_LIMIT


def test_flash_check_blocks_names_the_design_and_refuses_what_neither_runs():
    assert tfa.check_blocks(128, 128, 128, itemsize=2, strides=QWEN_STRIDES) == "wgmma"
    assert tfa.check_blocks(128, 16, 32, itemsize=2) == "simt"
    assert tfa.check_blocks(32, 64, 64, itemsize=4) == "simt"
    with pytest.raises(ValueError, match="head dim"):
        tfa.check_blocks(256, 64, 64, itemsize=2)
    for args, msg in (((128, 256, 64, 2), "threads"), ((128, 128, 512, 2), "shared memory")):
        with pytest.raises(ValueError, match=msg) as e:
            tfa.check_blocks(*args)
        assert classify_failure(e.value) == "illegal"


# ------------------------------------------------- defaults, spaces, builds
def test_defaults_at_qwen2_7b_shapes_take_the_tensor_cores():
    a = torch.empty(4096, 3584, dtype=torch.bfloat16, device="meta")
    b = torch.empty(3584, 18944, dtype=torch.bfloat16, device="meta")
    knobs = tat.get_spec("matmul").defaults(a, b)
    assert knobs == {"bm": 128, "bn": 256, "bk": 64}
    assert tmm.design(knobs["bm"], knobs["bn"], knobs["bk"], 2) == "wgmma"
    q = torch.empty(2, 2048, 28, 128, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 4, 2048, 128, dtype=torch.bfloat16, device="meta")
    knobs = tat.get_spec("flash_attention").defaults(q, kv, kv)
    assert knobs == {"block_q": 128, "block_kv": 128}
    assert tfa.design(2, 128, knobs["block_q"], knobs["block_kv"], QWEN_STRIDES) == "wgmma"


@pytest.mark.parametrize("name,shapes", [
    ("matmul", [(4096, 3584), (3584, 18944)]),
    ("matmul", [(256, 192), (192, 128)]),
    ("flash_attention", [(2, 2048, 28, 128), (2, 4, 2048, 128), (2, 4, 2048, 128)]),
    ("flash_attention", [(1, 64, 8, 32), (1, 2, 64, 32), (1, 2, 64, 32)]),
])
def test_search_spaces_equal_the_jax_packages(name, shapes):
    targs = [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in shapes]
    jargs = [jnp.zeros(s, jnp.bfloat16) for s in shapes]
    tdims = tat.get_spec(name).space(*targs).dims
    jdims = jat.get_spec(name).space(*jargs).dims
    assert [(d.name, d.lo, d.hi) for d in tdims] == [(d.name, d.lo, d.hi) for d in jdims]


def test_tensor_core_sources_are_built_with_the_others():
    for name in ("matmul_wgmma", "flash_attention_wgmma"):
        assert name in _cuda.SOURCES
        assert '#include "hopper.cuh"' in (_cuda.CSRC / f"{name}.cu").read_text()
    assert (_cuda.CSRC / "hopper.cuh").exists()


@pytest.mark.parametrize("name", _cuda.SOURCES)
def test_build_key_covers_the_shared_header(tmp_path, name):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    before = _cuda._lib_path(name, csrc)
    assert before == _cuda._lib_path(name, csrc)  # stable for unchanged bytes
    assert before == _cuda._lib_path(name)  # and the copy keys like the tree
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _cuda._lib_path(name, csrc) != before


def test_plain_path_counts_no_launch_of_either_design():
    before = (tmm.launches, dict(tmm.launches_by_design), tfa.launches, tfa.bwd_launches,
              dict(tfa.launches_by_design))
    a = torch.randn(128, 64).bfloat16()
    tmm.matmul_tiled(a, a.t().contiguous(), interpret=True)
    q = torch.randn(1, 2, 64, 32).bfloat16()
    o, lse = tfa.flash_attention_fwd(q, q, q, block_q=64, block_kv=64, interpret=True, return_lse=True)
    tfa.flash_attention_bwd(q, q, q, o, lse, q, block_q=64, block_kv=64, interpret=True)
    assert (tmm.launches, tmm.launches_by_design, tfa.launches, tfa.bwd_launches,
            tfa.launches_by_design) == before
    assert set(tmm.launches_by_design) == {"wgmma", "simt"}
    # flash attention's forward designs, and its backward's under their own keys
    assert set(tfa.launches_by_design) == {"wgmma", "simt", "bwd_wgmma", "bwd_simt"}


# ------------------------------------------------------ flash backward
_S8 = (8, 8, 8)  # batch, head and sequence strides that are multiples of 8 elements


@pytest.mark.parametrize("itemsize,hd,Sq,Skv,strides,aligned,want", [
    (2, 128, 2048, 2048, _S8, True, "wgmma"),  # qwen2-7b's layer
    (2, 64, 4096, 4096, _S8, True, "wgmma"),  # seamless's encoder layer
    (2, 16, 64, 192, _S8, True, "wgmma"),  # Sq != Skv, one 64-row tile
    (2, 32, 128, 64, _S8, True, "wgmma"),
    (4, 64, 2048, 2048, _S8, True, "simt"),  # fp32 never takes the tensor cores
    (2, 64, 96, 96, _S8, True, "simt"),  # not multiples of 64
    (2, 64, 128, 80, _S8, True, "simt"),
    (2, 48, 128, 128, _S8, True, "simt"),  # head dim not instantiated
    (2, 64, 128, 128, (8, 8, 4), True, "simt"),  # a row stride of 8 bytes
    (2, 64, 128, 128, _S8, False, "simt"),  # a tensor off a 16-byte boundary
])
def test_flash_bwd_design(itemsize, hd, Sq, Skv, strides, aligned, want):
    """The tensor-core backward takes every call the mma design took (bf16,
    an instantiated head dim, sequences that are multiples of 64, 16-byte
    rows and starts); everything else runs the CUDA-core design."""
    assert tfa.bwd_design(itemsize, hd, Sq, Skv, strides, aligned) == want


@pytest.mark.parametrize("Sq,Skv,want", [(2048, 2048, (128, 128)), (4096, 512, (128, 128)),
                                         (64, 192, (64, 64)), (192, 256, (64, 128))])
def test_flash_bwd_blocks(Sq, Skv, want):
    """Two consumer warpgroups (128 rows) a block where the sequence allows,
    else one (64)."""
    assert tfa.bwd_blocks(Sq, Skv) == want


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
@pytest.mark.parametrize("rows", [64, 128])
def test_flash_bwd_rings_fit_the_block(hd, rows):
    """Both passes' rings at every instantiated head dim and block: at least
    two stages, the most up to ``MAX_STAGES`` that fit 227 KB, and the
    shared memory the kernels compute (tiles rounded to 1024 bytes, lse and
    D rows, mbarriers, 1024 to align)."""
    dq_stages, kv_stages = tfa.bwd_ring_stages(hd, rows, rows)
    tile = -(-2 * 64 * hd // 1024) * 1024
    fixed = -(-2 * rows * hd // 1024) * 1024
    for stages, smem, per_stage in ((dq_stages, tfa.bwd_dq_smem_bytes, 2 * tile),
                                    (kv_stages, tfa.bwd_dkdv_smem_bytes, 2 * tile + 2 * 4 * 64)):
        assert 2 <= stages <= tfa.MAX_STAGES
        assert smem(hd, rows, stages) == 1024 + 2 * fixed + stages * per_stage + 8 * (1 + 2 * stages)
        assert smem(hd, rows, stages) <= SMEM_LIMIT
        assert stages == tfa.MAX_STAGES or smem(hd, rows, stages + 1) > SMEM_LIMIT


@pytest.mark.parametrize("B,Kh,g,sms,want", [
    (1, 4, 7, 132, 7),  # qwen2-7b's layer: 64 KV tiles of 128 keys at 2048 tokens, 16 at 512
    (3, 16, 1, 132, 1),  # seamless's encoder: 1536 tiles, g = 1
    (1, 8, 2, 132, 2),
    (1, 2, 8, 132, 8),  # no divisor fills the card: all g
    (4, 8, 4, 132, 1),  # the tiles alone fill it
    (1, 1, 16, 64, 4),
])
def test_flash_bwd_head_splits(B, Kh, g, sms, want):
    """The dK/dV pass's head split: 1 when the KV tiles fill the SMs, else
    the smallest divisor of g that does (or g); the same at 512 and 2048
    tokens for qwen2-7b's layer, and the call is three kernels at either
    length."""
    got = {S: tfa.bwd_head_splits(B, Kh, g, S, sms) for S in (512, 2048)}
    tiles = {S: B * Kh * S // tfa.bwd_blocks(S, S)[1] for S in got}
    for S, n in got.items():
        assert g % n == 0
        smaller = [d for d in range(1, n) if g % d == 0]
        assert all(tiles[S] * d < sms for d in smaller)
        assert n == g or tiles[S] * n >= sms
        assert tfa.bwd_design(2, 128, S, S, _S8) == "wgmma"
    assert got[2048] == want
    if B == 1 and Kh == 4:
        assert got[512] == got[2048] > 1
    assert tfa.BWD_KERNELS["wgmma"] == 3 and tfa.BWD_KERNELS["simt"] == 2


def test_flash_bwd_scratch_is_at_most_two_full_gradients():
    """The fp32 dK/dV partials: splits x (B, Kh, Skv, hd) each, so at most
    two (B, H, Skv, hd) fp32 arrays: 58.7 MB at qwen2-7b's layer (29.4 MB
    each), 100.7 MB at seamless's encoder (split 1)."""
    assert tfa.bwd_scratch_bytes(1, 4, 2048, 128, 7) == 2 * 4 * 28 * 2048 * 128 == 58720256
    assert tfa.bwd_scratch_bytes(3, 16, 4096, 64, 1) == 2 * 4 * 3 * 16 * 4096 * 64
    for B, Kh, g, S, hd in ((1, 4, 7, 2048, 128), (1, 8, 2, 1152, 64), (2, 2, 8, 512, 32)):
        n = tfa.bwd_head_splits(B, Kh, g, S, 132)
        assert tfa.bwd_scratch_bytes(B, Kh, S, hd, n) <= 2 * 4 * B * Kh * g * S * hd
