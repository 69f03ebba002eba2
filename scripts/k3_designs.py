"""K3's designs side by side on the card, on synthetic duals.

For each dtype and each m of --ms: B lanes of a dual made from a numpy seed
(D = A A^T / k + 1e-3 I, symmetric bit for bit, A [m, k] ~ N(0, 1) with
k = max(1, m // 2); r ~ N(0, 1); boxes lo = -U(0.1, 1), hi = U(0.1, 1)),
and every K3 launch that holds m: the thread design (m <= THREAD_UP_TO),
the warp design with each store of D that fits a block's shared memory
(the transpose, the triangle), and the earlier warp design (warp_div), which
is timed at each lane count of --div-Bs too. Each is held against qp.pgs_sweeps at
--check-iters sweeps (1e-10 of scale in float64, 2e-4 in float32), then
timed at --iters sweeps (10 launches in a CUDA graph, 100 at m <= 8, 3
past MAX_FIXED_M): ms, ns and cycles a row update (the SM clock nvidia-smi
reads under the warp design's launch at the widest m up to MAX_FIXED_M,
else the narrowest),
share of the bound (chip_smoke.k3_flops), lanes an SM and waves at B.
pgs_kernel.THREAD_UP_TO, the width up to which design_of takes the thread
design, was read off the crossover this prints (its builds held the thread
design to m = 14 in both dtypes).

    python scripts/k3_designs.py [--ms 1,2,4,7,8,12,16,24,32,33,48,64,72,80]
                                 [--B 1024] [--iters 3000] [--check-iters 100]
                                 [--div-Bs 512]

Needs one CUDA card; prints one line a launch, the card's name and power
limit, and a JSON line {"k3_designs": [...]}.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from redmax_tpu_torch import pgs_kernel, qp  # noqa: E402


def dual(m, B, dtype, seed=0):
    """(D, r, lo, hi) on the card, from the numpy seed."""
    rng = np.random.default_rng(seed)
    k = max(1, m // 2)
    A = rng.normal(size=(B, m, k))
    D = A @ A.transpose(0, 2, 1) / k + 1e-3 * np.eye(m)
    D = 0.5 * (D + D.transpose(0, 2, 1))
    r = rng.normal(size=(B, m))
    lo, hi = -rng.uniform(0.1, 1.0, size=(B, m)), rng.uniform(0.1, 1.0, size=(B, m))
    return tuple(torch.tensor(a, dtype=dtype, device="cuda") for a in (D, r, lo, hi))


def launches_at(m, dtype, B, div_Bs):
    """(design, store, lanes) of every K3 launch that holds m."""
    out = [("thread", "full", B)] if m <= pgs_kernel.THREAD_UP_TO[dtype] else []
    limit = pgs_kernel.layout(m, dtype, "warp_div")["max_smem"]
    out += [("warp", st, B) for st in ("full", "triangle")
            if pgs_kernel.smem_bytes(m, dtype, st) <= limit]
    return out + [("warp_div", "full", b) for b in dict.fromkeys([B] + div_Bs)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default="1,2,4,7,8,12,16,24,32,33,48,64,72,80")
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--check-iters", type=int, default=100)
    ap.add_argument("--div-Bs", default="",
                    help="more lane counts to time warp_div at (comma-separated)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_designs: torch.cuda is not available")
    smi = cs.nvidia_smi_line()
    ms = [int(v) for v in args.ms.split(",")]
    builds = list(dict.fromkeys(pgs_kernel.build_for(m) for m in ms))
    for build in builds:   # one nvcc each, side by side, all done before any launch
        build.start()
    for build in builds:
        pgs_kernel._lib(build)
    div_Bs = [int(v) for v in args.div_Bs.split(",") if v]
    B, iters, reg = args.B, args.iters, 1e-12
    rows = []
    for dtype in (torch.float64, torch.float32):
        m_clock = max([m for m in ms if m <= pgs_kernel.MAX_FIXED_M] or [min(ms)])
        D, r, lo, hi = dual(m_clock, B, dtype)
        clock, samples = cs.sm_clock_mhz(lambda: pgs_kernel.launch(
            D, r, lo, hi, iters, reg, design="warp", store="triangle"))
        print(f"{str(dtype)[6:]}: SM clock {clock:.0f} MHz ({samples} samples of nvidia-smi "
              f"under the warp design at m {m_clock}); card {smi}")
        for m in ms:
            D, r, lo, hi = dual(m, max([B] + div_Bs), dtype)
            ref = qp.pgs_sweeps(D, r, lo, hi, args.check_iters, reg, graph=True)
            tol = 1e-10 if dtype == torch.float64 else 2e-4
            peak = cs.PEAK_F64_FLOPS if dtype == torch.float64 else cs.PEAK_F32_FLOPS
            reps = 100 if m <= 8 else 10 if m <= pgs_kernel.MAX_FIXED_M else 3
            for design, store, b in launches_at(m, dtype, B, div_Bs):
                bound = max(cs.k3_flops(m, iters) * b / peak, D.element_size() * b
                            * (m * m + 4 * m) / cs.PEAK_BYTES_PER_S) * 1e3
                run = lambda n: pgs_kernel.launch(D[:b], r[:b], lo[:b], hi[:b], n, reg,
                                                  design=design, store=store)
                scale = max(1.0, float(ref[:b].abs().max()))
                err = float((run(args.check_iters) - ref[:b]).abs().max())
                if not err <= tol * scale:
                    raise AssertionError(f"K3 {design} ({store}) m {m} {dtype} B {b}: max "
                                         f"|d lam| {err} of scale {scale}")
                ms_ = cs.graph_ms(lambda: run(iters), reps=reps)
                ns = ms_ * 1e6 / (iters * m)
                lay = cs.k3_layout_fields(m, dtype, design, store, b)
                row = {"dtype": str(dtype)[6:], "m": m, "B": b, "design": design,
                       "store": store if design == "warp" else "full" if lay["shared_d"]
                       else "device", "ms": ms_,
                       "ns_per_row": ns, "cycles_per_row": ns * clock / 1e3,
                       "share_of_bound": bound / ms_, "bound_ms": bound, "max_abs_err": err,
                       **lay}
                rows.append(row)
                print(f"{row['dtype']} m {m:3d} B {b:4d} {design:8s} {row['store']:8s}: "
                      f"{ms_:9.4f} ms, "
                      f"{ns:6.1f} ns {row['cycles_per_row']:5.0f} cycles a row, "
                      f"{bound / ms_:7.2%} of bound, {row['lanes_per_sm']:3d} lanes an SM, "
                      f"{row['waves']} wave(s), {row['registers']} registers, spills "
                      f"{row['spill_store_bytes']}/{row['spill_load_bytes']}; max |d lam| "
                      f"{err:.2e} of {scale:.2e}")
    print(smi)
    print(json.dumps({"k3_designs": rows, "card": smi}))


if __name__ == "__main__":
    main()
