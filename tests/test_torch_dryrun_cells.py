"""The JAX dry-run tests' nine tiny cells (``tests/test_dryrun_small.py``)
and its multi-pod cell, counted by the port's dry run on a fake (4, 4) /
(2, 2, 4) process group through ``python -m repro_torch.launch.dryrun``'s
``main``: each must end ``1 ok``, with the result dict's keys and an
``H100_SXM`` roofline (modelled, the data sheet).  Apart from
``tests/test_torch_dryrun.py`` so that the two run side by side.
"""
import json

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

from repro_torch.launch import dryrun


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2_7b", "train_4k", "4,4"),
    ("arctic_480b", "train_4k", "4,4"),  # MoE dispatch collectives
    ("rwkv6_7b", "train_4k", "4,4"),  # recurrence, no attention
    ("recurrentgemma_2b", "train_4k", "4,4"),  # hybrid + window
    ("seamless_m4t_large_v2", "train_4k", "4,4"),  # encoder-decoder
    ("llama_3_2_vision_11b", "train_4k", "4,4"),  # cross-attn
    ("qwen2_7b", "prefill_32k", "4,4"),
    ("qwen2_7b", "decode_32k", "4,4"),
    ("rwkv6_7b", "long_500k", "4,4"),
    ("qwen2_7b", "train_4k", "2,2,4"),  # multi-pod
])
def test_tiny_cell_counts(arch, shape, mesh, tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--tiny", "--mesh", mesh,
                        "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "1 ok, 0 skipped, 0 errors" in printed and "h100-sxm, modelled" in printed
    r = json.loads(out.read_text())
    assert r["status"] == "ok" and r["chips"] == 16 and r["hw"] == "h100-sxm"
    assert list(r["mesh"].values()) == [int(d) for d in mesh.split(",")]
    assert set(r["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                                "alias_bytes"}
    assert r["memory"]["peak_bytes"] >= r["memory"]["argument_bytes"] > 0
    rf = r["roofline"]
    assert rf["flops"] > 0 and rf["bytes_accessed"] > 0 and rf["chips"] == 16
    assert rf["compute_s"] == rf["flops"] / 989e12 and rf["memory_s"] == rf["bytes_accessed"] / 3.35e12
    assert rf["collective_s"] == rf["coll_bytes"] / (25e9 * 18)
    if shape == "train_4k":  # parameters and optimizer state are updated in place
        assert r["memory"]["alias_bytes"] > 0
