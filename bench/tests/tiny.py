"""A benchmark cell cut to the program's tiny configuration, for the CPU:
the same files, loops, reference and limits, at sizes a test can hold."""
from __future__ import annotations

import dataclasses

from bench.harness.spec import load_cell

#: traffic at tiny sizes, by kind
TINY_TRAFFIC = {
    "train": {"seq_len": 32, "frames": 16},
    "serve": {"prompt_lens": [16, 32], "gen": 16, "trace_gen": 8, "frames": 16},
}


def tiny_cell(name: str, compute_dtype: str = "float32", layers: int = 0, d_model: int = 0,
              vocab: int = 0, **traffic):
    """``name``'s cell with the tiny config of its architecture, computing
    in ``compute_dtype``; ``layers`` (each stack), ``d_model`` (heads of
    64) and ``vocab`` make it larger; ``traffic`` overrides the tiny mix."""
    from repro_torch import configs

    cell = load_cell(name)
    arch = cell.config["port"]["arch"]
    cfg = configs.get_tiny(arch)
    if layers or d_model or vocab:
        d = d_model or cfg.d_model
        cfg = dataclasses.replace(
            cfg, n_layers=layers or cfg.n_layers, n_groups=layers or cfg.n_layers,
            enc_layers=(layers or cfg.enc_layers) if cfg.enc_layers else 0, d_model=d,
            n_heads=d // 64, n_kv_heads=d // 64, d_head=64, d_ff=4 * d,
            vocab_size=vocab or cfg.vocab_size)
    sizes = dict(cell.config["sizes"], n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
                 d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 d_head=cfg.d_head, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                 source_vocab_size=cfg.vocab_size, vocab_pad_multiple=cfg.vocab_pad_multiple)
    shape = {k: getattr(cfg, k) for k in ("n_layers", "n_groups", "enc_layers", "d_model",
                                          "n_heads", "n_kv_heads", "d_head", "d_ff",
                                          "vocab_size")}
    port = {"arch": arch, "tiny": True, "overrides": {"compute_dtype": compute_dtype, **shape}}
    cell.config = dict(cell.config, sizes=sizes, port=port)
    mix = dict(TINY_TRAFFIC[cell.traffic["kind"]])
    if not cell.traffic.get("frames"):
        mix["frames"] = 0
    if cell.traffic.get("prompt_len"):
        mix["prompt_len"] = 8
    if cell.traffic["kind"] == "serve" and cell.traffic["prompt_lens"] == [4]:
        mix["prompt_lens"] = [4]
    cell.traffic = dict(cell.traffic, **{**mix, **traffic})
    return cell

