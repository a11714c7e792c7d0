"""The port's host-side builders against the JAX package's, exactly.

The port copies the NumPy builders (grid parsing, tree schedules, feeder
networks, trajectory comparison) because the JAX package cannot be imported
where the port runs; these tests hold each copy equal to the original.
Also checks that the port imports neither JAX nor the JAX package, and
Gymnasium only in its Gymnasium adapters, which nothing else imports.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from gym_anm_tpu import check as jcheck
from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.envs.feeder141 import _NETWORK as JAX_F141
from gym_anm_tpu.ops.pallas_tree import build_tree_schedule as jax_build_tree_schedule
from gym_anm_tpu.ops.tree_nr import build_tree_info as jax_build_tree_info

from gym_anm_tpu_torch import check
from gym_anm_tpu_torch.core.grid import ARRAY_FIELDS, GridSpec, build_grid, spec_from_numpy
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network, make_multi_feeder_network
from gym_anm_tpu_torch.ops.tree_cuda import build_tree_schedule
from gym_anm_tpu_torch.ops.tree_nr import build_tree_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gym_anm_tpu_torch")

NETWORKS = {
    "anm6": (anm6_network, jax_anm6_network),
    "feeder33": (make_feeder_network(), JAX_F33),
    "feeder141": (make_multi_feeder_network(), JAX_F141),
}


def _assert_equal(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _assert_network_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "baseMVA":
            assert a[k] == b[k]
            continue
        x, y = np.asarray(a[k], dtype=object), np.asarray(b[k], dtype=object)
        assert x.shape == y.shape, k
        for u, v in zip(x.ravel(), y.ravel()):
            assert (u is None and v is None) or u == v, (k, u, v)


@pytest.mark.parametrize("name", ["feeder33", "feeder141"])
def test_feeder_networks_equal_jax(name):
    ours, theirs = NETWORKS[name]
    _assert_network_equal(ours, theirs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_build_grid_equals_jax(name, dtype):
    ours_net, jax_net = NETWORKS[name]
    spec, _ = build_grid(ours_net, 0.25, 100, dtype=dtype)
    jspec, _ = jax_build_grid(jax_net, 0.25, 100, dtype=dtype)
    assert [f.name for f in dataclasses.fields(spec)] == [f.name for f in dataclasses.fields(jspec)]
    for f in dataclasses.fields(spec):
        _assert_equal(getattr(spec, f.name), getattr(jspec, f.name), f.name)
    # The JAX spec's fields carried across give the same spec.
    carried = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    for f in dataclasses.fields(GridSpec):
        _assert_equal(getattr(carried, f.name), getattr(spec, f.name), f.name)
    assert set(ARRAY_FIELDS) == {k for k, v in vars(spec).items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("name", ["anm6", "feeder33", "feeder141"])
def test_tree_builders_equal_jax(name):
    ours_net, _ = NETWORKS[name]
    spec, _ = build_grid(ours_net, 0.25, 100, dtype=np.float32)
    args = (spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im)
    info, jinfo = build_tree_info(*args), jax_build_tree_info(*args)
    for f in dataclasses.fields(jinfo):
        _assert_equal(getattr(info, f.name), getattr(jinfo, f.name), f.name)
    sched, jsched = build_tree_schedule(*args, align=1), jax_build_tree_schedule(*args, align=1)
    for f in dataclasses.fields(jsched):
        _assert_equal(getattr(sched, f.name), getattr(jsched, f.name), f.name)
    # The port's default is the exact layout; float64 keeps the f64 admittances.
    assert build_tree_schedule(*args).levels == jsched.levels
    s64 = build_tree_schedule(*args, dtype=np.float64)
    assert s64.ycols.dtype == np.float64
    np.testing.assert_array_equal(s64.ycols.astype(np.float32), jsched.ycols)


def test_meshed_grid_has_no_schedule():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float64)
    br_f = np.append(spec.br_f, 4)
    br_t = np.append(spec.br_t, 5)
    assert build_tree_schedule(br_f[1:], br_t[1:], spec.n_bus, spec.Y_re, spec.Y_im) is None
    assert build_tree_info(br_f, br_t, spec.n_bus, spec.Y_re, spec.Y_im) is None


def test_compare_trajectories_equals_jax():
    rng = np.random.default_rng(0)
    T, B, n = 6, 32, 4
    ref = {
        "state_vec": rng.normal(size=(T, B, n)),
        "reward": rng.normal(size=(T, B)),
        "terminated": rng.uniform(size=(T, B)) < 0.1,
    }
    got = {
        "state_vec": ref["state_vec"] + 1e-3 * rng.normal(size=(T, B, n)),
        "reward": ref["reward"] + 1e-3 * rng.normal(size=(T, B)),
        "terminated": ref["terminated"] ^ (rng.uniform(size=(T, B)) < 0.02),
    }
    for kw in ({}, {"term_tol": 0.5, "state_tol": 1.0, "reward_tol": 1.0}):
        assert check.compare_trajectories(ref, got, **kw) == jcheck.compare_trajectories(ref, got, **kw)
    assert check.ref_path("anm6easy") == jcheck.ref_path("anm6easy")


def _port_modules():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                yield path, os.path.relpath(path, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")


# The Gymnasium adapters: the only port modules that may import Gymnasium.
# Nothing else in the port imports them, so the card (which has no
# Gymnasium) runs every other module and chip_smoke.py.
GYMNASIUM_MODULES = (
    "gym_anm_tpu_torch.envs.anm_env",
    "gym_anm_tpu_torch.envs.anm6.anm6",
    "gym_anm_tpu_torch.envs.anm6.anm6_easy_gym",
    "gym_anm_tpu_torch.envs.feeder33_gym",
    "gym_anm_tpu_torch.envs.feeder141_gym",
    "gym_anm_tpu_torch.envs.baranwu33_gym",
    "gym_anm_tpu_torch.envs.vector",
    "gym_anm_tpu_torch.envs.registration",
)


def _import_blocked(modules, blocked, extra=""):
    """Import ``modules`` in a fresh interpreter with ``blocked`` made
    unimportable; afterwards none of them may be loaded."""
    code = (
        "import sys\n"
        "for m in %r: sys.modules[m] = None\n"
        "import importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "%s"
        "assert not any(k.split('.')[0] in %r and v is not None for k, v in sys.modules.items())\n"
        % (blocked, sorted(modules), extra, blocked)
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _absolute_imports(path):
    """The top-level package of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _port_scripts():
    """The scripts and examples that drive the port."""
    for d in ("scripts", "examples"):
        for f in sorted(os.listdir(os.path.join(REPO, d))):
            path = os.path.join(REPO, d, f)
            if f.endswith(".py") and "gym_anm_tpu_torch" in open(path).read():
                yield path


def test_port_imports_no_jax():
    forbidden = ("jax", "jaxlib", "gym_anm_tpu", "flax", "optax")
    modules = []
    for path, mod in _port_modules():
        modules.append(mod)
        for n in _absolute_imports(path):
            assert n not in forbidden, (mod, n)
            assert n != "gymnasium" or mod in GYMNASIUM_MODULES, (mod, n)
    assert set(GYMNASIUM_MODULES) <= set(modules)
    # The port's scripts and examples (an example may use Gymnasium).
    scripts = list(_port_scripts())
    assert len(scripts) >= 20
    for path in scripts:
        assert not set(_absolute_imports(path)) & set(forbidden), path
    # Every other module, and chip_smoke.py, imports with JAX and Gymnasium
    # made unimportable; the Gymnasium adapters import with JAX made
    # unimportable.
    _import_blocked([m for m in modules if m not in GYMNASIUM_MODULES],
                    ("jax", "jaxlib", "gymnasium", "gym_anm_tpu"), "import chip_smoke\n")
    _import_blocked(GYMNASIUM_MODULES, ("jax", "jaxlib", "gym_anm_tpu"))


def test_check_config_equals_jax():
    assert set(check.CHECK_CONFIG) == set(jcheck.CHECK_CONFIG)
    for env in check.CHECK_CONFIG:
        assert check.CHECK_CONFIG[env] == jcheck.CHECK_CONFIG[env]


def test_entry_points_default_to_the_card():
    import inspect

    from gym_anm_tpu_torch.core import state
    from gym_anm_tpu_torch.envs import baranwu33, feeder33, feeder141
    from gym_anm_tpu_torch.envs.anm6 import anm6_easy

    from gym_anm_tpu_torch.envs.anm_env import ANMEnv

    for fn in (anm6_easy.make_core, feeder33.make_core, feeder141.make_core, baranwu33.make_core, state.zeros_state,
               state.sim_state_from_numpy, state.env_state_from_numpy, ANMEnv, anm6_easy.ANM6Easy, feeder33.Feeder33Env,
               feeder141.Feeder141Env, baranwu33.Baranwu33Env):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
