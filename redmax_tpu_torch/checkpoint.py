"""Checkpoint / resume (the JAX package's checkpoint.py; the reference's
closest feature is Scene.history with reset()/reLoad()).

A long MPC or optimization run snapshots its (state, optimizer state,
params, step counter) and resumes bit-exactly. The format is the JAX
package's npz backend: the tree's leaves as leaf_00000, leaf_00001, ... in
JAX's leaf order (dict keys sorted; tuples, lists, NamedTuples and dataclass
fields in order; None holds no leaf), so a file written by either package
loads in the other. The port has no orbax: "auto" means npz, and "orbax"
raises ImportError, as the JAX package does where orbax is absent.
"""

import dataclasses
import os
from typing import Any, Callable, List

import numpy as np
import torch


def tree_flatten(tree: Any) -> List[Any]:
    """The leaves of a tree of dicts, tuples, lists, NamedTuples and
    dataclasses, in JAX's order. A leaf is anything else (a tensor, an
    array, a Python number)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_flatten(t)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in tree_flatten(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """like's structure with its leaves replaced, in tree_flatten's order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return type(t)((k, built[k]) for k in t)
        if isinstance(t, (tuple, list)):
            items = [build(x) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(
                t, **{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_flatten(tree)])


def _backend(backend: str) -> None:
    if backend == "orbax":
        raise ImportError("orbax requested but not importable (the port saves npz)")
    if backend not in ("auto", "npz"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(value: np.ndarray, like):
    """A leaf read from a file, as the kind of leaf like is: a tensor on
    like's device (the file's dtype), a Python number, or an array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(value.item())
    return value


def save_checkpoint(path: str, tree: Any, backend: str = "auto") -> str:
    """Save a tree (state, optimizer state, params, counters) to path.npz;
    returns that path. Serialization errors propagate: a checkpoint that
    silently failed to write is worse than a crash."""
    _backend(backend)
    np.savez(path + ".npz",
             **{f"leaf_{i:05d}": _to_numpy(x) for i, x in enumerate(tree_flatten(tree))})
    return path + ".npz"


def load_checkpoint(path: str, like: Any, backend: str = "auto") -> Any:
    """Restore a tree with the structure of like (path with or without its
    .npz). A file whose leaf count differs from like's raises ValueError."""
    _backend(backend)
    flat = tree_flatten(like)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        keys = sorted(k for k in data.files if k.startswith("leaf_"))
        if len(keys) != len(flat):
            raise ValueError(f"checkpoint has {len(keys)} leaves, expected {len(flat)}")
        return tree_unflatten(like, [_like(data[k], x) for k, x in zip(keys, flat)])


def checkpointed_run(iterate: Callable, carry0: Any, n_iters: int, ckpt_dir: str,
                     every: int = 10, backend: str = "auto") -> Any:
    """Run carry = iterate(carry, i) for i in [start, n_iters), writing a
    checkpoint of (carry, i + 1) every `every` iterations and at the end,
    and resuming from the latest checkpoint in ckpt_dir if there is one: a
    run invoked again after an interrupt continues where its last snapshot
    left off and replays no optimizer step. Returns the final carry."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = os.path.join(ckpt_dir, "latest")
    carry, start = carry0, 0
    if os.path.exists(tag + ".npz"):
        carry, it = load_checkpoint(tag, (carry0, torch.zeros((), dtype=torch.int32)),
                                    backend=backend)
        start = int(it)
    for i in range(start, n_iters):
        carry = iterate(carry, i)
        if (i + 1) % every == 0 or (i + 1) == n_iters:
            save_checkpoint(tag, (carry, torch.tensor(i + 1, dtype=torch.int32)),
                            backend=backend)
    return carry
