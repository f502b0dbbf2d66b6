"""Exact conversion between the reference's params pytree and the port's model.

The reference keeps parameters as a nested dict
`{"q0"|"q1"|"q2"|"f"|"g"|"qb": {"layers": [(W, b), ...], "mean": (W, b),
"raw_scale": s}, "prior": {"mean": m, "raw_scale": s}}`. Given that tree as
numpy arrays (`jax.tree_util.tree_map(np.asarray, params)` on the JAX side),
`load_numpy_params` copies it into an `SSM` and `params_to_numpy` rebuilds
it, bit for bit; `grads_to_numpy` gives the parameters' gradients in the same
tree. `load_params_npz` reads a snapshot that the reference's
`benchmark.save_params_npz` wrote (one array per leaf, keyed by the leaf's
path as `jax.tree_util.keystr` prints it, e.g. `['f']['layers'][0][0]`).
Shapes and keys are checked; nothing is converted silently.
"""

from __future__ import annotations

import numpy as np
import torch

from psvo_tpu_torch.models.ssm import SSM

HEADS = ("q0", "q1", "q2", "f", "g", "qb")


def params_to_numpy(ssm: SSM) -> dict:
    """The model's parameters as the reference's pytree of float32 arrays."""
    return _tree(ssm, lambda t: t)


def grads_to_numpy(ssm: SSM) -> dict:
    """The `.grad` of every parameter as the reference's pytree (zeros for a
    parameter that has none), to compare with `jax.grad` leaf by leaf."""
    return _tree(ssm, lambda t: torch.zeros_like(t) if t.grad is None else t.grad)


def _tree(ssm: SSM, leaf) -> dict:
    def arr(t):
        return leaf(t).detach().cpu().numpy().copy()

    tree = {}
    for name in HEADS:
        head = ssm.heads[name]
        tree[name] = {
            "layers": [(arr(w), arr(b)) for w, b in head.layers()],
            "mean": (arr(head.mean_w), arr(head.mean_b)),
            "raw_scale": arr(head.raw_scale),
        }
    tree["prior"] = {"mean": arr(ssm.prior_mean), "raw_scale": arr(ssm.prior_raw_scale)}
    return tree


def load_params_npz(ssm: SSM, path) -> SSM:
    """Copy a flat .npz params snapshot into `ssm`, in place. Every leaf of
    the model's tree is looked up under its keystr path; a missing key or a
    leaf of another shape raises, as the reference's loader does."""

    with np.load(path) as data:
        def fill(node, key: str):
            if isinstance(node, dict):
                return {k: fill(v, f"{key}[{k!r}]") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(fill(v, f"{key}[{i}]") for i, v in enumerate(node))
            if key not in data.files:
                raise ValueError(f"{path}: no leaf {key}")
            arr = data[key]
            if arr.shape != node.shape:
                raise ValueError(f"{path}: leaf {key} has shape {arr.shape}, "
                                 f"the model wants {node.shape}")
            return arr

        tree = fill(params_to_numpy(ssm), "")
    return load_numpy_params(ssm, tree)


def _copy(dst: torch.Tensor, src, where: str) -> None:
    src = np.asarray(src)
    if src.dtype != np.float32:
        raise ValueError(f"{where}: expected float32, got {src.dtype}")
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {src.shape} != model's {tuple(dst.shape)}")
    dst.copy_(torch.tensor(src))


def load_numpy_params(ssm: SSM, tree: dict) -> SSM:
    """Copy the reference's params pytree (numpy leaves) into `ssm`, in place."""
    expected = set(HEADS) | {"prior"}
    if set(tree) != expected:
        raise ValueError(f"params keys {sorted(tree)} != {sorted(expected)}")
    with torch.no_grad():
        for name in HEADS:
            head, src = ssm.heads[name], tree[name]
            if set(src) != {"layers", "mean", "raw_scale"}:
                raise ValueError(f"{name}: unsupported head keys {sorted(src)}")
            if len(src["layers"]) != len(head.weights):
                raise ValueError(f"{name}: {len(src['layers'])} layers != model's {len(head.weights)}")
            for i, ((w, b), (dw, db)) in enumerate(zip(src["layers"], head.layers())):
                _copy(dw, w, f"{name}.layers[{i}].W")
                _copy(db, b, f"{name}.layers[{i}].b")
            _copy(head.mean_w, src["mean"][0], f"{name}.mean.W")
            _copy(head.mean_b, src["mean"][1], f"{name}.mean.b")
            _copy(head.raw_scale, src["raw_scale"], f"{name}.raw_scale")
        _copy(ssm.prior_mean, tree["prior"]["mean"], "prior.mean")
        _copy(ssm.prior_raw_scale, tree["prior"]["raw_scale"], "prior.raw_scale")
    return ssm
