"""Context fingerprints and tuning records.

A tuning result is only reusable inside the context it was measured in; the
fingerprint captures that context:

    (name, input signature, search-space hash, backend, device kind[, extra])

* ``name``       — the kernel / step being tuned ("matmul", "train_step/qwen2_7b").
* ``signature``  — canonical shapes+dtypes of the call's array arguments (plus
  any static scalars); different shapes are different keys.
* ``space_hash`` — hash of the search-space *structure* (dim kinds, names,
  bounds).  A changed space invalidates stored points.
* ``backend`` / ``device_kind`` — a block size tuned on one card says nothing
  about another, nor about the plain CPU version.  Derived from the call's
  tensors: ``("cuda", <card name>)`` on the card, ``("cpu", "cpu")`` on the
  CPU — the same strings the JAX package's CPU backend writes, so both
  packages' CPU keys are identical.
* ``extra``      — free-form context a caller wants keyed (global batch, ...).

Keys must be stable **across processes** (they are the on-disk dict keys), so
everything is canonical JSON + sha256 — never Python ``hash()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Mapping, Optional, Sequence

__all__ = [
    "SCHEMA_VERSION",
    "TuningKey",
    "TuningRecord",
    "make_key",
    "signature_of",
    "space_fingerprint",
    "default_device",
]

#: bump when the on-disk layout of records/keys changes incompatibly
SCHEMA_VERSION = 1


# ------------------------------------------------------------- fingerprints
def space_fingerprint(space) -> str:
    """Stable hash of a SearchSpace's structure (kind, name, bounds per dim)."""
    spec = []
    for d in space.dims:
        fields = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
        spec.append({"kind": type(d).__name__, **fields})
    # validity predicates shrink the feasible region, so they are part of the
    # context; constraint-free spaces hash exactly as before (stored kernel
    # keys stay valid)
    if getattr(space, "constraints", ()):
        spec.append({"kind": "constraints", "names": [c.name for c in space.constraints]})
    blob = json.dumps(spec, sort_keys=True, default=repr, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _dtype_name(dtype: Any) -> str:
    """numpy's name for a dtype: ``torch.bfloat16`` -> ``"bfloat16"``, so
    torch and numpy/JAX signatures of the same inputs compare equal."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _sig_entry(v: Any):
    if hasattr(v, "shape") and hasattr(v, "dtype"):  # torch / numpy arrays
        return ["array", _dtype_name(v.dtype), [int(s) for s in v.shape]]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return ["py", repr(v)]
    return ["py", f"<{type(v).__name__}>"]


def signature_of(args: Sequence[Any] = (), kwargs: Optional[Mapping[str, Any]] = None):
    """Canonical, JSON-able signature of a call's inputs."""
    sig = [_sig_entry(v) for v in args]
    for k in sorted(kwargs or {}):
        sig.append([k, _sig_entry(kwargs[k])])
    return sig


def default_device(args: Sequence[Any] = ()) -> tuple:
    """(backend, device_kind) of the device a call's tensors live on:
    ``("cuda", <card name>)`` for the first CUDA tensor in ``args``, else
    ``("cpu", "cpu")``."""
    for v in args:
        dev = getattr(v, "device", None)
        if getattr(dev, "type", None) == "cuda":
            import torch

            return "cuda", str(torch.cuda.get_device_name(dev))
    return "cpu", "cpu"


def _canon(x: Any) -> str:
    return json.dumps(x, sort_keys=True, default=repr, separators=(",", ":"))


# --------------------------------------------------------------------- keys
@dataclasses.dataclass(frozen=True)
class TuningKey:
    """Context fingerprint.  ``encode()`` is the canonical string form used as
    the on-disk dict key."""

    name: str
    signature: str  # canonical JSON (string so the dataclass stays hashable)
    space_hash: str
    backend: str
    device_kind: str
    extra: str = "{}"  # canonical JSON of caller-supplied context

    def encode(self) -> str:
        return "|".join(
            [
                f"v{SCHEMA_VERSION}",
                self.name,
                self.signature,
                self.space_hash,
                self.backend,
                self.device_kind,
                self.extra,
            ]
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "TuningKey":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def shard(self, num_shards: int) -> int:
        """Deterministic shard assignment for fleet pretuning.

        A stable hash (sha256 of the canonical encoding — never Python
        ``hash()``, which is salted per process) of the full fingerprint,
        reduced mod ``num_shards``: every worker of a fleet computes the
        same shard for the same context with **zero coordination**, so
        ``pretune --shard i/n`` partitions the grid without a scheduler."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        h = hashlib.sha256(self.encode().encode()).digest()
        return int.from_bytes(h[:8], "big") % num_shards

    # --------------------------------------------------- neighbor matching
    def shapes(self) -> Optional[list]:
        """Array shapes in the signature, or None if it has none.  Memoized:
        ``nearest()`` calls this once per stored record per lookup."""
        try:
            return self._shapes_memo
        except AttributeError:
            pass
        try:
            sig = json.loads(self.signature)
            out = [e[2] for e in sig if isinstance(e, list) and e and e[0] == "array"]
            out = out or None
        except Exception:
            out = None
        # frozen dataclass: bypass the immutability guard for the cache slot
        object.__setattr__(self, "_shapes_memo", out)
        return out

    def distance(self, other: "TuningKey") -> float:
        """Log-scale shape distance to a candidate warm-start neighbor.

        Finite only for keys that describe *the same computation on the same
        hardware in the same execution context* (name, backend, device kind,
        extra — so e.g. interpreter-mode timings never warm-start compiled
        dispatch) with structurally matching signatures; then it is the summed
        |log2| ratio of array dims — the natural metric for block-size spaces,
        where good tiles move with the problem size by powers of two.
        ``space_hash`` may differ: neighbor shapes clamp the space bounds, and
        the warm-start path re-encodes the point into the current domain."""
        import math

        if (self.name, self.backend, self.device_kind, self.extra) != (
            other.name,
            other.backend,
            other.device_kind,
            other.extra,
        ):
            return math.inf
        a, b = self.shapes(), other.shapes()
        if a is None or b is None or len(a) != len(b):
            return math.inf
        d = 0.0
        for sa, sb in zip(a, b):
            if len(sa) != len(sb):
                return math.inf
            for xa, xb in zip(sa, sb):
                if xa <= 0 or xb <= 0:
                    return math.inf
                d += abs(math.log2(xa / xb))
        return d


def make_key(
    name: str,
    *,
    args: Sequence[Any] = (),
    kwargs: Optional[Mapping[str, Any]] = None,
    space=None,
    extra: Optional[Mapping[str, Any]] = None,
    backend: Optional[str] = None,
    device_kind: Optional[str] = None,
) -> TuningKey:
    """Build the context fingerprint for one tuning site."""
    if backend is None or device_kind is None:
        b, dk = default_device(list(args) + list((kwargs or {}).values()))
        backend = backend if backend is not None else b
        device_kind = device_kind if device_kind is not None else dk
    return TuningKey(
        name=name,
        signature=_canon(signature_of(args, kwargs)),
        space_hash=space_fingerprint(space) if space is not None else "-",
        backend=backend,
        device_kind=device_kind,
        extra=_canon(dict(extra or {})),
    )


# ------------------------------------------------------------------ records
@dataclasses.dataclass
class TuningRecord:
    """One persisted tuning result: the best point found for a context key.

    ``cost_std`` / ``repeats_spent`` carry the measurement confidence of the
    stored cost (standard deviation over the repetitions the measurement
    engine actually spent on the best point).  ``strategy`` is the search
    strategy spec that produced the record (``"csa"``, ``"csa+nm"``,
    ``"csa|nm"``, ... — see the JAX package's ``make_strategy``);
    ``objective`` is the statistic the stored cost minimizes (``"median"``,
    ``"p95"``, ``"p99"`` — see :data:`repro_torch.core.measure.OBJECTIVES`), so a
    p99-tuned record is never mistaken for a median cost.  All of these are
    optional: records written before the fields existed — and costs
    delivered by user cost functions — load as ``None``, which every
    consumer must treat as "unknown"."""

    key: TuningKey
    point: dict
    cost: float
    evals: int = 0
    source: str = "online"  # "online" | "pretune"
    created: float = dataclasses.field(default_factory=time.time)
    crashed: int = 0  # distinct candidates that failed during the search
    cost_std: Optional[float] = None  # std over the best point's measured reps
    repeats_spent: Optional[int] = None  # reps behind the stored cost
    strategy: Optional[str] = None  # search strategy spec behind the record
    objective: Optional[str] = None  # statistic the stored cost minimizes

    def known_std(self) -> Optional[float]:
        """The record's measured standard deviation, or ``None`` when it
        carries no *meaningful* confidence — absent fields (pre-engine
        records) and single-rep measurements (whose std of 0.0 is unknown,
        not perfect).  The shared definition behind ``commit()``'s near-tie
        guard and the fleet merge resolver."""
        if self.cost_std is None or (self.repeats_spent or 0) <= 1:
            return None
        return float(self.cost_std)

    def to_json(self) -> dict:
        return {
            "key": self.key.to_json(),
            "point": self.point,
            "cost": self.cost,
            "evals": self.evals,
            "source": self.source,
            "created": self.created,
            "crashed": self.crashed,
            "cost_std": self.cost_std,
            "repeats_spent": self.repeats_spent,
            "strategy": self.strategy,
            "objective": self.objective,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "TuningRecord":
        cost_std = d.get("cost_std")
        repeats_spent = d.get("repeats_spent")
        strategy = d.get("strategy")
        objective = d.get("objective")
        return cls(
            key=TuningKey.from_json(d["key"]),
            point=dict(d["point"]),
            cost=float(d["cost"]),
            evals=int(d.get("evals", 0)),
            source=str(d.get("source", "online")),
            created=float(d.get("created", 0.0)),
            crashed=int(d.get("crashed", 0)),
            cost_std=float(cost_std) if cost_std is not None else None,
            repeats_spent=int(repeats_spent) if repeats_spent is not None else None,
            strategy=str(strategy) if strategy is not None else None,
            objective=str(objective) if objective is not None else None,
        )
