"""Shared setup of the torch-port tests: one config in both packages, one set
of weights in both models, and the reference's key-derived noise as numpy.

The JAX model is initialised from a key and its params are copied into the
port through `psvo_tpu_torch.bridge`, so both packages evaluate identical
models; noise is drawn with jax.random exactly as `psvo_tpu.smc`
(`forward_filter`, smc.py:686-697) draws it and handed to both as arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from psvo_tpu import config as jconfig
from psvo_tpu.models.ssm import init_ssm as j_init_ssm
from psvo_tpu.ops import resampling as j_resampling
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM


def small_configs(objective="fivo", k=128, hidden=(16, 16), t=8, resampling="systematic",
                  datatype="fhn", **smc_kw):
    """(reference Config, port Config) of the FHN slice (or, with
    datatype="lorenz63", of the Lorenz-63 one) at a small size."""
    net = jconfig.NetConfig(hidden=hidden)
    dim = 3 if datatype == "lorenz63" else 2
    jcfg = jconfig.Config(
        name="torch_port_test",
        data=jconfig.DataConfig(datatype=datatype, dx=dim, dy=dim, t_steps=t),
        smc=jconfig.SMCConfig(objective=objective, n_particles=k, resampling=resampling,
                              **smc_kw),
        train=jconfig.TrainConfig(mse_k_steps=3),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                g=dataclasses.replace(net, sigma_init=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def models(jcfg, tcfg, seed=0):
    """(reference SSM, its params, port SSM holding the same params)."""
    jssm, params = j_init_ssm(jcfg, jax.random.key(seed))
    tssm = SSM(tcfg)
    bridge.load_numpy_params(tssm, jax.tree_util.tree_map(np.asarray, params))
    return jssm, params, tssm


@pytest.fixture
def psvo_interpret(monkeypatch):
    """The reference's whole-scan, resampling and FFBSi Pallas kernels in
    interpret mode for one test: the PSVO kernel path on the CPU."""
    from psvo_tpu.ops import pallas_ffbsi, pallas_resample, pallas_step

    for mod in (pallas_ffbsi, pallas_resample, pallas_step):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def key_noise(key, batch, t_steps, dx, k, method="systematic"):
    """(eps0, eps_scan, u_scan) as numpy, derived from `key` as the
    reference's forward_filter derives them."""
    k0, k_prop, k_res = jax.random.split(key, 3)
    eps0 = jax.random.normal(k0, (batch, dx, k))
    eps_scan = jax.random.normal(k_prop, (t_steps - 1, batch, dx, k))
    if method != "none":
        u_scan = j_resampling.bulk_positions(k_res, t_steps - 1, batch, k, method)
    else:
        u_scan = np.zeros((t_steps - 1, batch, 1), np.float32)
    return tuple(np.asarray(a) for a in (eps0, eps_scan, u_scan))


def psvo_noise(key, batch, t_steps, dx, k, m):
    """The PSVO objective's draws from `key`, as the reference derives them:
    (eps0, eps_scan, u_scan) of the filter from the first half of the key,
    then the FFBSi Gumbels gum_anchor [B, M, K] and gum_scan [T−1, B, M, K]
    from the second (objectives._ffbsi_backward), as torch tensors."""
    from psvo_tpu import objectives as jobjectives

    k_fwd, k_bwd = jax.random.split(key)
    k_anchor, k_cat = jax.random.split(k_bwd)
    gum_anchor = jax.random.gumbel(k_anchor, (batch, m, k))
    gum_scan = jobjectives._gumbel_from_keys(jax.random.split(k_cat, t_steps - 1), (batch, m, k))
    return to_torch((*key_noise(k_fwd, batch, t_steps, dx, k), gum_anchor, gum_scan))


def segmented_psvo_noise(key, batch, t_steps, dx, k, m, n_segments, method="systematic"):
    """Segmented PSVO's draws from `key`, as the reference derives them, in
    the shape of `psvo_noise`: the filter's eps0 and one key pair per segment
    (`smc.forward_filter_segmented`, smc.py:836-839, and its fused form's
    preamble), each segment's (ε, u) from `smc._segment_randomness`
    (smc.py:231) laid end to end as eps_scan and u_scan; then the Gumbels of
    `objectives._ffbsi_backward_segmented` (objectives.py:599-603, 650,
    694), one key per support step, the same as the unsegmented sweep's."""
    from psvo_tpu import objectives as jobjectives

    k_fwd, k_bwd = jax.random.split(key)
    k0, k_prop, k_res = jax.random.split(k_fwd, 3)
    eps0 = jax.random.normal(k0, (batch, dx, k))
    seg_len = (t_steps - 1) // n_segments
    eps, u = [], []
    for kp, kr in zip(jax.random.split(k_prop, n_segments), jax.random.split(k_res, n_segments)):
        eps.append(jax.random.normal(kp, (seg_len, batch, dx, k)))
        u.append(j_resampling.bulk_positions(kr, seg_len, batch, k, method))
    k_anchor, k_cat = jax.random.split(k_bwd)
    gum_anchor = jax.random.gumbel(k_anchor, (batch, m, k))
    gum_scan = jobjectives._gumbel_from_keys(jax.random.split(k_cat, t_steps - 1), (batch, m, k))
    return to_torch((eps0, np.concatenate(eps), np.concatenate(u), gum_anchor, gum_scan))


def svo_noise(key, batch, t_steps, dx, k, m):
    """The SVO objective's draws from `key`, as the reference derives them:
    (eps0, eps_scan, u_scan) of the filter from the first half of the key,
    then the anchor Gumbels gum_anchor [B, M, K] and the backward proposal's
    noise eps_svo [T−1, B, M, Dx] from the second
    (objectives._svo_backward), as torch tensors."""
    k_fwd, k_bwd = jax.random.split(key)
    k_anchor, k_eps = jax.random.split(k_bwd)
    gum_anchor = jax.random.gumbel(k_anchor, (batch, m, k))
    eps_svo = jax.random.normal(k_eps, (t_steps - 1, batch, m, dx))
    return to_torch((*key_noise(k_fwd, batch, t_steps, dx, k), gum_anchor, eps_svo))


def to_torch(arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


def observations(batch, t_steps, dy=2, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, t_steps, dy)).astype(np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def assert_grads_close(got_tree, want_tree, rtol, atol):
    """Every leaf of the port's gradient tree (`bridge.grads_to_numpy`)
    against the reference's `jax.grad` tree, named by its path on failure."""
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_got = jax.tree_util.tree_leaves(got_tree)
    assert len(flat_got) == len(flat_want)
    for (path, want), got in zip(flat_want, flat_got):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@contextlib.contextmanager
def without_compile_cache():
    """Compile the reference's mesh programs afresh, outside the persistent
    compilation cache that `psvo_tpu` turns on: with the cache warm, the
    execution of a loaded executable of the 8-virtual-device mesh aborted
    the process (SIGABRT) in 2 of 4 runs of tests/test_torch_sharding_paths.py
    started side by side, and in none with the cache off."""
    enabled = jax.config.jax_enable_compilation_cache
    compilation_cache.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        compilation_cache.reset_cache()


def sharded_reference(jssm, jcfg, params, key, ys, controls=None):
    """The reference's objective under its mesh (jcfg.mesh over the virtual
    CPU devices of tests/conftest.py), jitted value_and_grad: (loss, its
    ObjectiveOutput, the gradient tree), as numpy."""
    from psvo_tpu.objectives import make_objective as j_make_objective
    from psvo_tpu.parallel import context as jcontext
    from psvo_tpu.parallel import sharding as jsharding

    mesh = jsharding.make_mesh(jcfg)
    ssm_sh, cfg_sh = jsharding.prepare_sharded(jssm, jcfg, mesh)
    objective = j_make_objective(ssm_sh, cfg_sh)
    jcontext.set_mesh(mesh)
    try:
        place = jsharding.batch_sharding(mesh)
        ys = jax.device_put(ys, place)
        controls = None if controls is None else jax.device_put(controls, place)

        def loss(p):
            out = objective(p, key, ys, controls=controls)
            return out.loss, out

        with without_compile_cache():
            (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
            return jax.tree_util.tree_map(np.asarray, (value, out, grads))
    finally:
        jcontext.set_mesh(None)


def grads_tree(tcfg, grads):
    """The port's gradient list (in `parameters()` order) as the reference's
    pytree (`bridge.grads_to_numpy`)."""
    tssm = SSM(tcfg)
    for p, g in zip(tssm.parameters(), grads):
        p.grad = g
    return bridge.grads_to_numpy(tssm)
