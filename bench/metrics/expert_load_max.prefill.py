"""The most-loaded expert's assignments over the mean expert's, in the most
uneven MoE layer, over the run's prefills: from the program's per-layer
device counters ``moe.expert_assignments.<layer>`` in its metrics registry
(``models/moe.py``; eager calls only, so on the card the prefills and not
the decode graphs), read after the window.  1 is an even load."""


def read(ctx):
    from repro_torch.obs.metrics import registry

    loads = [v for k, v in registry().snapshot().items()
             if k.startswith("moe.expert_assignments.") and v and sum(v)]
    if not loads:
        return None
    return max(max(v) * len(v) / sum(v) for v in loads)
