"""Inputs from the seed: the same seed gives the same inputs, a large seed
works, every length cycle is whole, and a prompt's labels are left out."""
import torch

from bench.harness.inputs import mix_seed, prompt_lengths, serve_batch, train_batch
from bench.harness.spec import load_cell

SIZES = {"vocab_size": 1000, "source_vocab_size": 900, "d_model": 8}


def test_same_seed_same_batch_and_rows_differ():
    mix = {"batch": 3, "seq_len": 16, "frames": 4, "prompt_len": 5}
    a = train_batch(SIZES, mix, 2**33 + 7, 4, "cpu")
    b = train_batch(SIZES, mix, 2**33 + 7, 4, "cpu")
    c = train_batch(SIZES, mix, 2**33 + 7, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 3
    assert (a["labels"][:, :5] == -1).all()
    assert torch.equal(a["labels"][:, 5:-1], a["tokens"][:, 6:])
    assert a["frames"].shape == (3, 4, 8)


def test_cycles_are_whole_permutations():
    mix = {"prompt_lens": [1024, 2048, 4096]}
    order = prompt_lengths(mix, 2**31 + 99, 12)
    for i in range(0, 12, 3):
        assert sorted(order[i:i + 3]) == [1024, 2048, 4096]
    assert order == prompt_lengths(mix, 2**31 + 99, 12)


def test_serve_batch():
    mix = {"batch": 8, "gen": 16, "frames": 0}
    b = serve_batch(SIZES, mix, 11, 3, 32, "cpu")
    assert b["tokens"].shape == (8, 32) and b["max_len"] == 48 and "frames" not in b
    assert int(b["tokens"].max()) < SIZES["source_vocab_size"]


def test_tokens_are_drawn_below_the_source_vocabulary():
    sizes = load_cell("seamless_m4t_large_v2.serve").sizes
    assert sizes["source_vocab_size"] == 256102 < sizes["vocab_size"] == 256206
    mix = {"batch": 64, "gen": 4, "frames": 0}
    assert int(serve_batch(sizes, mix, 5, 0, 512, "cpu")["tokens"].max()) < 256102
    rwkv = load_cell("rwkv6_7b.train").sizes
    assert rwkv["source_vocab_size"] == rwkv["vocab_size"]


def test_seed_mixing_is_63_bit():
    assert 0 <= mix_seed(2**40 + 3, "train", 7) < 2**63
    assert mix_seed(1, "train", 0) != mix_seed(1, "serve", 0)


def test_the_cells_mixes_load():
    cell = load_cell("rwkv6_7b.train")
    assert cell.traffic["prompt_len"] < cell.traffic["seq_len"]
