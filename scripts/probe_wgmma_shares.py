#!/usr/bin/env python3
"""Where the time of the tensor-core matmul and flash kernels goes, on one
CUDA card: each kernel timed with one part of its work cut out.

    python3 scripts/probe_wgmma_shares.py

The script copies ``csrc/matmul_wgmma.cu`` and ``csrc/flash_attention_wgmma.cu``
into ``build/shares/``, cuts one piece out of each copy (a text edit that
must apply), builds every copy with the port's ``nvcc`` flags, and times
each (CUDA events, one warm-up, 100 repetitions) through the port's own
wrapper at the qwen2-7b shapes of ``chip_smoke.py``: the matmul (4096, 3584)
@ (3584, 18944) at its default tile 128/256/64, causal flash attention q
(2, 2048, 28, 128), k/v (2, 4, 2048, 128) at 128/128.  Every copy is timed
once in each of ``ROUNDS`` rounds (the whole kernel first); each line gives
the median time over the rounds, the fastest and the slowest, and the share
of the median whole kernel's time that the part takes: the gap between the
whole kernel and the copy without the part (parts overlap, so the shares
need not add up).  The times of one copy spread between rounds, so a share
smaller than that spread is not told apart from 0.

The cut copies compute wrong results on purpose; only their times mean
anything.  One copy is a variant and not a cut: ``single_p`` rounds P to
bf16 once (no lo part), and its worst error against the plain version over
the 5e-3 limit of ``chip_smoke.py`` is printed: what the hi + lo split
buys.  It prints the card's name and power limit first and exits 1 without
a card.
"""
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

ROUNDS = 7

# (name, what the copy leaves out, [(text, replacement), ...])
MATMUL_CUTS = [
    ("whole", "nothing", []),
    ("no_epilogue", "the bf16 stores of C",
     [("*reinterpret_cast<uint32_t*>(c + row * N + col) = hopper::pack_bf16(acc[ms][i], acc[ms][i + 1]);",
       "if (acc[ms][i] == 12345.f) *reinterpret_cast<uint32_t*>(c) = 0;")]),
    ("no_wgmma", "every wgmma (loads, barriers and stores stay)",
     [("hopper::Wgmma<BN>::template ss<1>(acc[ms], da, db, 1);", "acc[ms][0] += static_cast<float>(da + db);")]),
    ("wait_all", "the overlap of one stage's products with the next stage's issue (wait<0>)",
     [("hopper::wgmma_wait<1>();  // the previous stage's products are done", "hopper::wgmma_wait<0>();")]),
]
FLASH_CUTS = [
    ("whole", "nothing", []),
    ("no_exp", "the exp2 of the scores and of the rescale (SFU)",
     [("const float p = hopper::exp2_approx(fmaf(sacc[i], sl2, -m[(i >> 1) & 1]));",
       "const float p = fmaf(sacc[i], sl2, -m[(i >> 1) & 1]);"),
      ("alpha[r] = hopper::exp2_approx(m[r] - m_new);", "alpha[r] = m[r] - m_new;")]),
    ("no_pv", "the P V products",
     [("hopper::Wgmma<HD>::template rs<1>(oacc, ph[c], dv, 1);", "oacc[c] += __uint_as_float(ph[c][0]);"),
      ("hopper::Wgmma<HD>::template rs<1>(oacc, pl[c], dv, 1);", "")]),
    ("no_s", "the Q K^T products",
     [("hopper::Wgmma<BKV>::template ss_overwrite<0>(sacc, dq, dk);",
       "for (int i = 0; i < BKV / 2; ++i) sacc[i] = static_cast<float>(dq + dk + i);"),
      ("hopper::Wgmma<BKV>::template ss<0>(sacc, dq, dk, 1);", "")]),
    ("single_p", "the lo half of P (one bf16 rounding of P)",
     [("hopper::split_bf16(sacc[8 * c + 2 * j], sacc[8 * c + 2 * j + 1], ph[c][j], pl[c][j]);",
       "ph[c][j] = hopper::pack_bf16(sacc[8 * c + 2 * j], sacc[8 * c + 2 * j + 1]);"),
      ("hopper::fence_regs(pl[c]);", ""),
      ("hopper::Wgmma<HD>::template rs<1>(oacc, pl[c], dv, 1);", "")]),
]


def cuda_ms(fn, reps: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_wgmma_shares: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    out_dir = ROOT / "build" / "shares"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, cuts in (("matmul_wgmma", MATMUL_CUTS), ("flash_attention_wgmma", FLASH_CUTS)):
        text = (_cuda.CSRC / f"{source}.cu").read_text()
        for name, _, edits in cuts:
            copy = text
            for old, new in edits:
                if old not in copy:
                    raise SystemExit(f"probe_wgmma_shares: cut {source}/{name} no longer applies: {old!r}")
                copy = copy.replace(old, new)
            path = out_dir / f"{source}-{name}.cu"
            path.write_text(copy)
            jobs.append((source, name, path))
    nvcc = _cuda._nvcc()

    def build(job):
        source, name, path = job
        lib = path.with_suffix(".so")
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(lib), str(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"probe_wgmma_shares: {path.name} did not build:\n{proc.stdout}{proc.stderr}")
        return source, name, lib

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(build, jobs))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((4096, 3584), generator=gen, device=dev).bfloat16()
    b = (torch.randn((3584, 18944), generator=gen, device=dev) / 60).bfloat16()
    q = torch.randn((2, 2048, 28, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((2, 4, 2048, 128), generator=gen, device=dev).bfloat16()
    v = torch.randn((2, 4, 2048, 128), generator=gen, device=dev).bfloat16()
    calls = {"matmul_wgmma": lambda: ops.matmul(a, b, bm=128, bn=256, bk=64),
             "flash_attention_wgmma": lambda: ops.flash_attention(q, k, v, causal=True, block_q=128,
                                                                  block_kv=128)}
    what = {(s, n): w for s, cuts in (("matmul_wgmma", MATMUL_CUTS), ("flash_attention_wgmma", FLASH_CUTS))
            for n, w, _ in cuts}
    real = {s: _cuda.load(s) for s in calls}
    times = {(source, name): [] for source, name, _ in libs}
    try:
        for _ in range(ROUNDS):  # each source's whole copy is timed first in each round
            for source, name, lib in libs:
                _cuda._libs[source] = ctypes.CDLL(str(lib))
                times[(source, name)].append(cuda_ms(calls[source]))
        single = {s: lib for s, n, lib in libs if n == "single_p"}
        _cuda._libs["flash_attention_wgmma"] = ctypes.CDLL(str(single["flash_attention_wgmma"]))
        got_single = calls["flash_attention_wgmma"]()
    finally:
        _cuda._libs.update(real)
    got_split = calls["flash_attention_wgmma"]()
    want = fa.flash_attention_plain(q.transpose(1, 2), k, v, causal=True, block_q=128,
                                    block_kv=128).transpose(1, 2).float()

    def worst(got):  # the largest error over chip_smoke.py's bf16 flash limit
        return ((got.float() - want).abs() / (5e-3 + 5e-3 * want.abs())).max().item()

    whole = {s: statistics.median(times[(s, "whole")]) for s in calls}
    for (source, name), ts in times.items():
        med = statistics.median(ts)
        print(f"{source} without {what[(source, name)]} ({name}): median {med:.4f} ms "
              f"(min {min(ts):.4f}, max {max(ts):.4f}, {ROUNDS} rounds), "
              f"{(whole[source] - med) / whole[source]:+.3f} of the whole kernel's {whole[source]:.4f} ms")
    print(f"flash_attention_wgmma at 128/128 against its plain version (limit 5e-3): worst err/limit "
          f"{worst(got_split):.3f} with P split into hi + lo, {worst(got_single):.3f} with P rounded once")
    return 0


if __name__ == "__main__":
    sys.exit(main())
