"""Finds what a cell is made of by name: its workload file, configuration,
traffic mix, reference and per-layer metric readers, and the metrics that
``BENCHMARK.json`` names for it.

    bench/workloads/<cell>.json    config, traffic, chips, limits
    bench/configs/<config>.json    source, reduced, assumed, sizes, port, reference
    bench/traffic/<mix>.json       kind (train or serve) and its parameters
    bench/reference/<name>.py      recipe, forward, train_loss, model_flops
    bench/metrics/<metric>.py      read(ctx) -> value or None

Adding a cell, a configuration or a per-layer metric adds files here and
entries in ``BENCHMARK.json``; nothing in the harness changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["BENCH", "ROOT", "Cell", "load_cell", "metric_reader", "derived_sizes"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def derived_sizes(sizes: dict) -> dict:
    """The configuration's sizes with the derived ones filled in: the head
    width, as many key/value heads as query heads, the source's vocabulary
    (which tokens and labels are drawn below) as the program's, and the
    vocabulary padded to ``vocab_pad_multiple``."""
    out = dict(sizes)
    out.setdefault("d_head", out["d_model"] // out["n_heads"])
    out.setdefault("n_kv_heads", out["n_heads"])
    out.setdefault("source_vocab_size", out["vocab_size"])
    out.setdefault("enc_layers", 0)
    m = out.get("vocab_pad_multiple", 256)
    out.setdefault("padded_vocab", -(-out["vocab_size"] // m) * m)
    return out


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list

    @property
    def sizes(self) -> dict:
        return derived_sizes(self.config["sizes"])

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})

    def reference(self):
        return importlib.import_module(f"bench.reference.{self.config['reference']}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files resolved; raises ``FileNotFoundError``
    or ``KeyError`` when one is missing."""
    bench = root / "bench"
    spec = _json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in spec["workloads"]}[name]
    workload = _json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {workload[key]!r} in its workload file "
                             f"and {entry[key]!r} in BENCHMARK.json")
    config = _json(bench / "configs" / f"{workload['config']}.json")
    traffic = _json(bench / "traffic" / f"{workload['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']} lists no workloads")
    per_layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return Cell(name, workload, config, traffic, e2e, per_layer)


def metric_reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
