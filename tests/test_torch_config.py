"""The torch port's config mirror, params bridge and import hygiene.

The port keeps its own copy of the config tree (the reference's package
imports jax); these tests hold the copy to the reference preset by preset,
check that params cross the bridge bit for bit, and that importing the port
(and the chip smoke script) pulls in no jax.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.models.ssm import init_ssm as j_init_ssm
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from tests._torch_port import models, small_configs

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match_reference(name):
    want, got = jconfig.PRESETS[name], tconfig.PRESETS[name]
    assert got.to_dict() == want.to_dict()
    assert got.config_hash() == want.config_hash()
    assert got.resume_hash() == want.resume_hash()
    assert tconfig.from_dict(got.to_dict()) == got


def test_from_dict_matches_reference_on_overrides():
    d = jconfig.PRESETS["fhn_fivo_tril"].to_dict()
    d["data"]["dyn_overrides"] = [["dt", 0.1]]
    assert tconfig.from_dict(d).to_dict() == jconfig.from_dict(d).to_dict()
    assert tconfig.from_dict(d).config_hash() == jconfig.from_dict(d).config_hash()


def test_params_bridge_roundtrip_is_exact():
    jcfg, tcfg = small_configs(hidden=(16, 16, 16))
    _, params, tssm = models(jcfg, tcfg, seed=3)
    want = jax.tree_util.tree_map(np.asarray, params)
    got = bridge.params_to_numpy(tssm)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_params_bridge_rejects_mismatched_shapes():
    jcfg, tcfg = small_configs(hidden=(16, 16))
    _, params = j_init_ssm(jcfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    _, wide = small_configs(hidden=(32, 32))
    with pytest.raises(ValueError, match="shape"):
        bridge.load_numpy_params(SSM(wide), tree)


def test_port_init_matches_reference_tree():
    """Same tree, shapes and dtypes as SSM.init (the bits differ: other RNG),
    the same closed-form scales, and Glorot bounds on every weight."""
    jcfg = jconfig.PRESETS["fhn_fivo_k1024_bench"]
    _, params = j_init_ssm(jcfg, jax.random.key(0))
    want = jax.tree_util.tree_map(np.asarray, params)
    got = bridge.params_to_numpy(init_ssm(tconfig.PRESETS["fhn_fivo_k1024_bench"],
                                          torch.Generator().manual_seed(0), device="cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        b = want
        for p in path:
            b = b[p.key if hasattr(p, "key") else p.idx]
        assert a.shape == b.shape and a.dtype == b.dtype, path
    for name in ("q0", "q1", "q2", "f", "g", "qb"):
        np.testing.assert_allclose(got[name]["raw_scale"], want[name]["raw_scale"], rtol=1e-6)
        for w, b in got[name]["layers"] + [got[name]["mean"]]:
            assert np.abs(w).max() <= np.sqrt(6.0 / sum(w.shape)) and w.std() > 0
            assert not b.any()


def test_port_imports_no_jax():
    code = (
        "import sys; import psvo_tpu_torch, psvo_tpu_torch.bridge, "
        "psvo_tpu_torch.ops.fused_step, psvo_tpu_torch.ops._build, chip_smoke; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'psvo_tpu', 'triton')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
