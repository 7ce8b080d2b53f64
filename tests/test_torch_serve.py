"""The port's serving launcher on the CPU (``--tiny --device cpu``: the
kernels' plain versions), and its refusal to run without a card.

Two runs on one DB: the first tunes the decode fusion depth online and
persists it; the second is a DB hit that skips tuning; ``--no-tune``
replays the stored depth.  ``--epsilon 0.5`` makes every second routed
chunk an explore, so the search over the four depths finishes inside 64
tokens whatever depths the timings favour.  This file imports no JAX.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro_torch.launch import serve
from repro_torch.tuning import TuningDB

ROOT = Path(__file__).resolve().parents[1]


def _run(capsys, argv):
    out = serve.serve(argv)
    return out, capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b"])
def test_serve_tiny_on_the_cpu_tunes_then_hits_the_db(arch, tmp_path, capsys):
    db = str(tmp_path / "serve.json")
    argv = ["--arch", arch, "--tiny", "--device", "cpu", "--prompt-len", "16", "--gen", "64",
            "--epsilon", "0.5", "--db", db]
    first, text = _run(capsys, argv)
    assert not first["db_hit"] and "tuning db hit" not in text
    assert re.search(r"decode: 64 tok/seq x 8 in \d+ ms", text)
    assert first["hidden"].shape == (8, first["model"].cfg.d_model)
    assert bool(torch.isfinite(first["hidden"].float()).all())
    assert os.path.exists(db)
    second, text = _run(capsys, argv)
    assert second["db_hit"] and f"tuning db hit: decode k={first['k']}" in text
    # same weights and prompt from the same seeds: the same prefill
    assert torch.equal(second["hidden"], first["hidden"])
    # --no-tune replays what the DB holds now (a drift re-tune in the second
    # run may have recommitted another depth)
    (stored,) = TuningDB(db, autosave=False).records()
    static, text = _run(capsys, argv + ["--no-tune"])
    assert static["k"] == stored.point["k"] and f"static k={stored.point['k']}" in text


def test_decode_key_names_the_graph_form():
    """On the card decode runs as CUDA graphs, so its depth records carry the
    form in ``extra``: a depth tuned by the eager loop never hits.  The
    CPU's key is the eager loop's, as before."""
    from repro_torch.core import ChoiceDim, SearchSpace
    from repro_torch.tuning import make_key

    space = SearchSpace([ChoiceDim("k", serve.DECODE_KS)])
    card = "NVIDIA H100 80GB HBM3"
    eager = serve.decode_extra("recurrentgemma_2b", False, 8, card, graphs=False)
    graph = serve.decode_extra("recurrentgemma_2b", False, 8, card, graphs=True)
    assert graph == dict(eager, decode="cuda_graph")
    assert serve.decode_extra("rwkv6_7b", True, 8, "cpu", graphs=False) == {
        "arch": "rwkv6_7b", "tiny": True, "batch": 8, "device": "cpu"}
    keys = [make_key("serve/decode_k", space=space, extra=e) for e in (eager, graph)]
    assert keys[0].encode() != keys[1].encode()


def test_decode_graphs_need_the_card():
    """There is no CPU form of a CUDA graph: on the CPU serving decodes with
    the eager loop, and the graph set refuses a CPU model."""
    from repro_torch import configs
    from repro_torch.models import ExecConfig, Model

    model = Model(configs.get_tiny("rwkv6_7b"), ExecConfig(interpret=True), device="cpu")
    tokens = torch.zeros(2, 4, dtype=torch.int64)
    _, states = model.prefill({"tokens": tokens, "max_len": 8})
    with pytest.raises(ValueError, match="on the card"):
        serve.DecodeGraphs(model, tokens[:, :1], states, 4)


def test_serve_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.main(["--tiny"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(serve.NoCudaDevice):
        serve.serve(["--tiny", "--device", "cuda"])


def test_serve_cli_exits_nonzero_without_a_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
                           "--arch", "rwkv6_7b"], capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr and "prefill" not in proc.stdout
