#!/usr/bin/env python3
"""Probe rwkv6-7b training at full width on one CUDA card: memory by depth,
and where the kernel path's gradients part from the plain path's.

    python3 scripts/probe_rwkv_train.py --depths 2 4
    python3 scripts/probe_rwkv_train.py --layers 17 --per-call
    python3 scripts/probe_rwkv_train.py --forward --steps 0 3

Every mode builds ``chip_smoke.py``'s phase-24 model (rwkv6-7b at full
width, weights from seed 0, 1 x 2048 tokens, ``rec_chunk`` 8) at the given
depth and trains it 3 steps (``--forward``: each count of ``--steps``)
with its AdamW, then works on batch 0 with no update.  It prints the card's name and power limit first and exits 1
without a card.

``--depths N ...`` runs ``chip_smoke.rwkv_train_phase`` at each depth (its
peak, step ms and checks), from which phase 24's depth cut is reckoned.
``--per-call`` runs one forward + backward on the kernel path capturing each
``rwkv_scan`` backward call's inputs and cotangents, prints the parameters
whose kernel-path and plain-path (``wkv_chunked``) gradients differ most,
and then, call by call, the backward kernel and autograd through
``wkv_chunked`` against ``rwkv_scan_bwd_plain`` on the captured tensors (the
largest error over each output's largest value).  ``--forward`` captures each
layer's ``rwkv_scan`` inputs on the kernel path and holds the tensor-core
design's y, the per-token design's, ``wkv_chunked``'s, the sub-chunked
plain version's and a TF32 witness's (the sub-chunked form with the
operands of y's products rounded to TF32 as the kernel rounds them) against
the exact per-token scan in fp32, before and after the per-head group norm
the model applies next; then the loss and global gradient norm of the
kernel path with each forward design and with its backward through
``rwkv_scan_bwd_plain``, and of the plain path with and without the
witness forward and with its y replaced by another forward's (gradients
straight through); ``--paths-only`` leaves out the per-layer table.
"""
import argparse
import dataclasses
import gc
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.kernels import linear_scan as ls  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models import ExecConfig, TrainModel  # noqa: E402
from repro_torch.models.rwkv6 import wkv_chunked  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train import make_loss_fn, make_train_step  # noqa: E402

OUTPUTS = ("dr", "dk", "dv", "dlw", "du", "ds0")


def trained(layers: int, dev, steps: int = cs.RWKV_TRAIN_STEPS):
    """Phase 24's model at ``layers`` after ``steps`` steps, and batch 0."""
    cfg = dataclasses.replace(tconfigs.get("rwkv6_7b"), n_layers=layers, n_groups=0)
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda", rec_chunk=cs.TRAIN_REC_CHUNK), device=dev,
                       seed=0)
    params = model.params()
    opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
    state, step = opt.init(params), make_train_step(model, opt)
    for i in range(steps):
        params, state, _ = step(params, state, make_batch_for(cfg, 1, 2048, step=i, seed=0, device=dev))
    del state, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return model, make_batch_for(cfg, 1, 2048, step=0, seed=0, device=dev)


def grads_of(model, batch, impl: str) -> tuple:
    """(loss, global grad norm, {name: grad on the host}) of one pass."""
    model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=cs.TRAIN_REC_CHUNK)
    loss, norm = cs.loss_and_grads(model, batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.params().items()}
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return loss, norm, grads


def per_call(model, batch, dev) -> None:
    captured, backward = [], ops._Rwkv.backward

    def capture(ctx, gy, gs):
        captured.append([t.detach().cpu() for t in (*ctx.saved_tensors, gy, gs)])
        return backward(ctx, gy, gs)

    ops._Rwkv.backward = staticmethod(capture)
    try:
        lk, nk, gk = grads_of(model, batch, "cuda")
    finally:
        ops._Rwkv.backward = backward
    lp, npl, gp = grads_of(model, batch, "xla")
    print(f"kernel path loss {lk:.6f} grad norm {nk:.6f}; plain path loss {lp:.6f} grad norm {npl:.6f}")
    rows = sorted(((gk[n] - gp[n]).norm().item(), gk[n].norm().item(), gp[n].norm().item(), n) for n in gk)
    for diff, a, b, n in rows[::-1][:8]:
        print(f"  {n}: |kernel - plain| {diff:.4e}, |kernel| {a:.4e}, |plain| {b:.4e}")
    for i, args in enumerate(captured):  # the backward runs the last layer first
        args = [t.to(dev) for t in args]
        got = ls.rwkv_scan_bwd(*args)
        want = ls.rwkv_scan_bwd_plain(*args)
        leaves = [t.detach().clone().requires_grad_(True) for t in args[:6]]
        chunked = torch.autograd.grad(wkv_chunked(*leaves, chunk=cs.TRAIN_REC_CHUNK), leaves, args[6:])
        parts = []
        for name, g_, w_, c_ in zip(OUTPUTS, got, want, chunked):
            scale = w_.float().abs().max().item() + 1e-30
            parts.append(f"{name} kernel {(g_.float() - w_.float()).abs().max().item() / scale:.2e} "
                         f"chunked {(c_.float() - w_.float()).abs().max().item() / scale:.2e}")
        print(f"  backward call {i} (lw in [{args[3].min().item():.3f}, {args[3].max().item():.3f}]): "
              + "; ".join(parts))
        del got, want, chunked, leaves, args
        torch.cuda.empty_cache()


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as ``cvt.rna.tf32.f32`` rounds it."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def subchunk_tf32(r, k, v, lw, u, s0, sub: int = ls.TC_SUBCHUNK):
    """``rwkv_scan_subchunk_plain`` with the tensor-core kernel's roundings:
    r e^{c}, the state and the intra scores go to TF32 before y's products
    (v is bf16, exact in TF32); the state update stays fp32.  fp32 y, sT."""
    B, T, H, hd = r.shape
    rf, kf, vf, wf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, lw))
    S = s0.float().clone()
    ys = []
    below = torch.tril(torch.ones(sub, sub, dtype=torch.bool, device=r.device), diagonal=-1)
    for t0 in range(0, T, sub):
        rr, kk, vv = rf[:, :, t0:t0 + sub], kf[:, :, t0:t0 + sub], vf[:, :, t0:t0 + sub]
        c = torch.cumsum(wf[:, :, t0:t0 + sub], dim=2)
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)
        diff = cprev[:, :, :, None, :] - c[:, :, None, :, :]
        dec = torch.exp(torch.where(below[:, :, None], diff, torch.full_like(diff, -float("inf"))))
        scores = torch.einsum("bhti,bhsi,bhtsi->bhts", rr, kk, dec)
        scores = scores + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rr, u.float(), kk))
        ys.append(tf32(rr * torch.exp(cprev)) @ tf32(S) + tf32(scores) @ vv)
        cl = c[:, :, -1]
        S = torch.exp(cl)[..., None] * S + (kk * torch.exp(cl[:, :, None] - c)).transpose(-1, -2) @ vv
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), S


def group_norm(y):
    """The model's per-head normalisation of the scan's output (before its
    scale and bias), in fp32 from y as given."""
    y = y.float()
    mu = y.mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt((y - mu).square().mean(-1, keepdim=True) + 64e-5)


def forward(model, batch, steps: int, layers: bool = True) -> None:
    captured, scan = [], ops.rwkv_scan

    def capture(r, k, v, lw, u, s0, **kw):
        captured.append([t.detach().clone() for t in (r, k, v, lw, u, s0)])
        return scan(r, k, v, lw, u, s0, **kw)

    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=cs.TRAIN_REC_CHUNK)
    ops.rwkv_scan = capture if layers else scan
    try:
        with torch.no_grad():
            make_loss_fn(model)(model.params(), batch)
    finally:
        ops.rwkv_scan = scan
    tol = cs.TOL["rwkv_scan"]["bfloat16"]
    print(f"after {steps} steps: {len(captured)} rwkv_scan calls captured; per layer, each y against "
          f"the exact scan in fp32 as ||y - exact|| / ||exact|| (max |y - exact| / max |exact|), "
          f"then gn = the per-head group norm of y (bf16 y for the bf16 outputs)")
    for i, args in enumerate(captured):
        r, k, v, lw, u, s0 = args
        f32 = (r.float(), k.float(), v.float(), lw, u, s0)
        lwc, uc, s0c = (x.float().contiguous() for x in (lw, u, s0))
        ys = {"tc": ls._rwkv_launch(r, k, v, lwc, uc, s0c, cs.TRAIN_REC_CHUNK, "tc")[0],
              "per_token": ls._rwkv_launch(r, k, v, lwc, uc, s0c, cs.TRAIN_REC_CHUNK, "per_token")[0],
              "wkv_chunked": wkv_chunked(*args, chunk=cs.TRAIN_REC_CHUNK)[0],
              "witness_fp32": subchunk_tf32(*args)[0],
              "subchunk_fp32": ls.rwkv_scan_subchunk_plain(*f32)[0]}
        ys["witness"] = ys["witness_fp32"].to(r.dtype)
        exact = ref.rwkv_scan_ref(*f32)[0]
        ys["exact_bf16"] = exact.to(r.dtype)
        gn_exact = group_norm(exact)
        parts = []
        for name, y in ys.items():
            d = y.float() - exact
            gd = group_norm(y) - gn_exact
            parts.append(f"{name} {(d.norm() / exact.norm()).item():.2e} "
                         f"({(d.abs().max() / exact.abs().max()).item():.2e}) gn "
                         f"{(gd.norm() / gn_exact.norm()).item():.2e}")
        sub = ys["subchunk_fp32"].to(r.dtype).float()
        worst = ((ys["tc"].float() - sub).abs() / (tol + tol * sub.abs())).max().item()
        same = (ys["tc"] == ys["witness"]).float().mean().item()
        var = (exact - exact.mean(-1, keepdim=True)).square().mean(-1)
        print(f"  layer {i}: |exact| max {exact.abs().max().item():.3e} rms {exact.square().mean().sqrt().item():.3e}, "
              f"head variance below eps in {(var < 64e-5).float().mean().item():.2%}; " + "; ".join(parts)
              + f"; tc vs subchunk plain (bf16) worst err/limit {worst:.3f} at {tol:g}; tc equal to the "
              f"witness in {same:.2%} of elements")
        del ys, exact, args, f32
    del captured
    torch.cuda.empty_cache()

    orig_design, orig_chunked = ls.rwkv_design, rwkv6.wkv_chunked

    def witness_chunked(r, k, v, lw, u, s0, chunk=32):
        y, S = orig_chunked(r, k, v, lw, u, s0, chunk=chunk)
        yw = subchunk_tf32(*(x.detach() for x in (r, k, v, lw, u, s0)))[0].to(y.dtype)
        return y + (yw - y).detach(), S

    def substituted(make_y):
        """``wkv_chunked`` whose y is replaced by ``make_y``'s (rounded to
        y's dtype), its gradient passed straight through."""
        def fn(r, k, v, lw, u, s0, chunk=32):
            y, S = orig_chunked(r, k, v, lw, u, s0, chunk=chunk)
            with torch.no_grad():
                y2 = make_y(*(x.detach() for x in (r, k, v, lw, u, s0))).to(y.dtype)
            return (y.float() + (y2.float() - y.float()).detach()).to(y.dtype), S
        return fn

    def launch(design):
        return lambda r, k, v, lw, u, s0: ls._rwkv_launch(
            r, k, v, lw.float().contiguous(), u.float().contiguous(), s0.float().contiguous(),
            cs.TRAIN_REC_CHUNK, design)[0]

    kernel_bwd = ls.rwkv_scan_bwd
    for label, impl, design, chunked in (
            ("kernel path, tc forward", "cuda", None, None),
            ("kernel path, tc forward, backward through rwkv_scan_bwd_plain", "cuda", None, "plain_bwd"),
            ("kernel path, per_token forward", "cuda", "per_token", None),
            ("plain path (wkv_chunked)", "xla", None, None),
            ("plain path, TF32 witness forward", "xla", None, witness_chunked),
            ("plain path, y from the per_token kernel (exact, rounded once)", "xla", None,
             substituted(launch("per_token"))),
            ("plain path, y from the tc kernel", "xla", None, substituted(launch("tc"))),
            ("plain path, y from wkv_chunked at chunk 16", "xla", None,
             substituted(lambda *a: orig_chunked(*a, chunk=16)[0])),
            ("plain path, y from wkv_chunked at chunk 8 (itself)", "xla", None,
             substituted(lambda *a: orig_chunked(*a, chunk=cs.TRAIN_REC_CHUNK)[0]))):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=cs.TRAIN_REC_CHUNK)
        if design:
            ls.rwkv_design = lambda *a, **kw: design
        if chunked == "plain_bwd":
            ls.rwkv_scan_bwd = lambda *a, interpret=False: ls.rwkv_scan_bwd_plain(*a)
        elif chunked:
            rwkv6.wkv_chunked = chunked
        try:
            loss, norm = cs.loss_and_grads(model, batch)
        finally:
            ls.rwkv_design, rwkv6.wkv_chunked, ls.rwkv_scan_bwd = orig_design, orig_chunked, kernel_bwd
        print(f"  {label}: loss {loss:.6f}, global grad norm {norm:.6f}")
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[])
    ap.add_argument("--layers", type=int, default=cs.RWKV_TRAIN_LAYERS)
    ap.add_argument("--per-call", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--steps", type=int, nargs="*", default=[cs.RWKV_TRAIN_STEPS])
    ap.add_argument("--paths-only", action="store_true", help="--forward without the per-layer table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_rwkv_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    for depth in args.depths:
        cs.RWKV_TRAIN_LAYERS = depth
        _, report = cs.rwkv_train_phase(smi)
        print(f"depth {depth}: peak {report['peak_gb']:.2f} GB, step ms {report['step_ms']}")
        gc.collect()
        torch.cuda.empty_cache()
    if args.per_call:
        model, batch = trained(args.layers, dev)
        print(f"rwkv6-7b, {args.layers} layers, after {cs.RWKV_TRAIN_STEPS} steps, batch 0, no update:")
        per_call(model, batch, dev)
    if args.forward:
        for steps in args.steps:
            model, batch = trained(args.layers, dev, steps)
            print(f"rwkv6-7b, {args.layers} layers, after {steps} steps, batch 0, no update:")
            forward(model, batch, steps, layers=not args.paths_only)
            del model, batch
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
