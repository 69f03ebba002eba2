"""The one traffic generator: a mix's `inputs` as seeded tensors.

Each input is {"shape": [dims], "dist": "normal" | "uniform", ...}: a dim
is a number or the name of a traffic or configuration size ("B", "nr");
"normal" draws scale * N(0, 1), "uniform" U(low, high). `sets` input sets
are drawn in order, every input of a set in the file's order, from one
torch.Generator on the device seeded with --seed, in float64 and then cast
to the configuration's dtype: the same seed gives the same inputs."""

import torch


def make_inputs(traffic, sizes, seed, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sets = []
    for _ in range(int(traffic["sets"])):
        one = {}
        for name, spec in traffic["inputs"].items():
            shape = [int(sizes[d]) if isinstance(d, str) else int(d) for d in spec["shape"]]
            if spec["dist"] == "normal":
                x = float(spec["scale"]) * torch.randn(shape, generator=gen, device=device,
                                                       dtype=torch.float64)
            elif spec["dist"] == "uniform":
                lo, hi = float(spec["low"]), float(spec["high"])
                x = lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                                dtype=torch.float64)
            else:
                raise ValueError(f"input {name}: unknown dist {spec['dist']!r}")
            one[name] = x.to(dtype)
        sets.append(one)
    return sets
