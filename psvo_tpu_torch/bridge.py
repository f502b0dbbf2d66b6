"""Exact conversion between the reference's params pytree and the port's model.

The reference keeps parameters as a nested dict
`{"q0"|"q1"|"q2"|"f"|"g"|"qb": head, "prior": {"mean": m, "raw_scale": s}}`.
A head is `{"layers": [(W, b), ...], "mean": (W, b)}` plus the leaves of its
cov_type (`networks.MLPHead`): "raw_scale" s, "scale_head" (W, b),
"raw_tril" {"diag", "off"}, or "tril_diag_head" (W, b) and "tril_off_head"
(W, b), none for a mean-only head; a known-dynamics f is `{"raw_scale"[,
"ctrl_w"]}` (`networks.KnownTransition`); a model with SVO's backward GRU
(smc.qb_rnn) adds `"qb_rnn": {"z": (W, b), "r": (W, b), "h": (W, b)}`
(`networks.GRU`). Given that tree as
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

from psvo_tpu_torch import networks
from psvo_tpu_torch.models.ssm import SSM

HEADS = ("q0", "q1", "q2", "f", "g", "qb")


def params_to_numpy(ssm: SSM) -> dict:
    """The model's parameters as the reference's pytree of float32 arrays."""
    return _tree(ssm, lambda t: t)


def grads_to_numpy(ssm: SSM) -> dict:
    """The `.grad` of every parameter as the reference's pytree (zeros for a
    parameter that has none), to compare with `jax.grad` leaf by leaf."""
    return _tree(ssm, lambda t: torch.zeros_like(t) if t.grad is None else t.grad)


def _head_leaves(head):
    """(key, leaf) pairs of one head in the reference's layout: each leaf a
    tensor, or a tuple / dict of tensors."""
    if isinstance(head, networks.KnownTransition):
        return [("raw_scale", head.raw_scale)] + (
            [("ctrl_w", head.ctrl_w)] if hasattr(head, "ctrl_w") else [])
    leaves = [("layers", [(w, b) for w, b in head.layers()]),
              ("mean", (head.mean_w, head.mean_b))]
    if head.cov_type == "const":
        leaves.append(("raw_scale", head.raw_scale))
    elif head.cov_type == "head":
        leaves.append(("scale_head", (head.scale_w, head.scale_b)))
    elif head.cov_type == "tril":
        leaves.append(("raw_tril", {"diag": head.tril_diag, "off": head.tril_off}))
    elif head.cov_type == "tril_head":
        leaves += [("tril_diag_head", (head.tril_diag_w, head.tril_diag_b)),
                   ("tril_off_head", (head.tril_off_w, head.tril_off_b))]
    return leaves


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(v, fn) for v in node)
    return fn(node)


def _tree(ssm: SSM, leaf) -> dict:
    def arr(t):
        return leaf(t).detach().cpu().numpy().copy()

    tree = {name: {k: _map(v, arr) for k, v in _head_leaves(ssm.heads[name])}
            for name in HEADS}
    tree["prior"] = {"mean": arr(ssm.prior_mean), "raw_scale": arr(ssm.prior_raw_scale)}
    if ssm.qb_rnn:
        tree["qb_rnn"] = _map(ssm.gru.gates(), arr)
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


def _copy_node(dst, src, where: str) -> None:
    """Copy a leaf, or a tuple / list / dict of leaves, of the same layout."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{where}: keys {sorted(src) if isinstance(src, dict) else src!r} "
                             f"!= model's {sorted(dst)}")
        for k in dst:
            _copy_node(dst[k], src[k], f"{where}.{k}")
        return
    if isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{where}: {len(src) if isinstance(src, (list, tuple)) else src!r} "
                             f"entries != model's {len(dst)}")
        for i, (d, s_) in enumerate(zip(dst, src)):
            _copy_node(d, s_, f"{where}[{i}]")
        return
    _copy(dst, src, where)


def load_numpy_params(ssm: SSM, tree: dict) -> SSM:
    """Copy the reference's params pytree (numpy leaves) into `ssm`, in place;
    every head's keys must be those of its cov_type (or a known-dynamics f's),
    and "qb_rnn" is there exactly when the model has the GRU."""
    expected = set(HEADS) | {"prior"} | ({"qb_rnn"} if ssm.qb_rnn else set())
    if set(tree) != expected:
        raise ValueError(f"params keys {sorted(tree)} != {sorted(expected)}")
    with torch.no_grad():
        for name in HEADS:
            leaves, src = dict(_head_leaves(ssm.heads[name])), tree[name]
            if set(src) != set(leaves):
                raise ValueError(f"{name}: unsupported head keys {sorted(src)} (the model's "
                                 f"are {sorted(leaves)})")
            for key, dst in leaves.items():
                _copy_node(dst, src[key], f"{name}.{key}")
        _copy(ssm.prior_mean, tree["prior"]["mean"], "prior.mean")
        _copy(ssm.prior_raw_scale, tree["prior"]["raw_scale"], "prior.raw_scale")
        if ssm.qb_rnn:
            _copy_node(ssm.gru.gates(), tree["qb_rnn"], "qb_rnn")
    return ssm
