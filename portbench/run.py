"""Run one cell of the benchmark of redmax_tpu_torch once, on the card of
this machine:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output (`correct`, `attempted`, `failed`, `metrics`, `device`, with
--trace 1 `breakdown`, then `checks`: each number compared with its limit),
and the same checks as the last lines of standard error. Exits non-zero,
with no result, without a card or with fewer cards than the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc builds go to redmax_tpu_torch/_build/)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench.harness import cell, spec
    chips = spec.cell(args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.exit(f"portbench: the cell needs {chips} CUDA device(s); this machine has {n}")
    torch.set_num_threads(1)
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
