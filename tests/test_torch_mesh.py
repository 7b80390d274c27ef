"""The port's mesh (runtime/mesh.py), sharding rules (runtime/sharding.py),
parameter axes (model.param_axes) and optimizer state axes, against
single-process references and the JAX package.

One world of four gloo ranks on the CPU (module-scoped, spawned by
runtime/mesh.launch) runs every collective and its autograd at 1x2, 2x1
and 2x2 over each axis, Megatron's f and g (and split / gather) under
torch.autograd.gradcheck in fp64; the import check runs inside a
spawned rank, and a world of one rank in this process.  The references
are numpy here.  The rules, the axes and the state
axes are held against JAX's (`spec_for_axes` and `batch_spec` on
`dist.abstract_mesh` meshes of (1, 2), (2, 2), (2, 4) and (16, 16) at every
registry arch's full CONFIG; `split_tree` axes; the optimizers'
`state_axes`).
"""

import functools

import jax
import numpy as np
import pytest

import torch_mesh_workers as W
from test_torch_common import REPO  # noqa: F401  (puts src on the path)

WORLD_TIMEOUT = 240  # seconds a spawned world may run (launch raises past it)
JAX_MESHES = ((1, 2), (2, 2), (2, 4), (16, 16))


@functools.lru_cache(maxsize=None)
def _world():
    from repro_torch.runtime import mesh

    return mesh.launch(W.collectives, (2, 2), device="cpu", threads=1, quiet=True,
                       timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world():
    return _world()


def _members(shape, rank, axis):
    """The ranks of `rank`'s group along `axis` on a (data, model) mesh, in
    the axis's order."""
    d_n, m_n = shape
    d, m = divmod(rank, m_n)
    return [j * m_n + m for j in range(d_n)] if axis == "data" else \
        [d * m_n + j for j in range(m_n)]


def _reference(shape, rank, axis):
    grp = _members(shape, rank, axis)
    n = len(grp)
    me = grp.index(rank)
    xs = [W.inputs(1, r, (4, 6)) for r in grp]
    s = sum(xs)
    out = {
        "psum": s, "pmax": np.max(xs, axis=0),
        "all_gather0": np.concatenate(xs, 0), "all_gather1": np.concatenate(xs, 1),
        "psum_scatter0": np.split(s, n, 0)[me], "psum_scatter1": np.split(s, n, 1)[me],
        "all_to_all": np.concatenate([np.split(x, n, 0)[me] for x in xs], 0),
        "broadcast": W.inputs(1, 0, (4, 6)),
    }
    c = {r: W.inputs(2, r, (4 * n, 6)) for r in grp}
    grads = {
        "all_gather": np.split(sum(c.values()), n, 0)[me],
        "psum_scatter": np.concatenate([W.inputs(2, r, (4 // n, 6)) for r in grp], 0),
        "all_to_all": np.concatenate([np.split(W.inputs(2, r, (4, 6)), n, 0)[me]
                                      for r in grp], 0),
        "f": sum(W.inputs(2, r, (4, 6)) for r in grp),
        "g": W.inputs(4, 0, (4, 6)),
        "split": np.concatenate([W.inputs(2, r, (4, 6 // n)) for r in grp], 1),
        "gather": np.split(W.inputs(4, 0, (4, 6 * n)), n, 1)[me],
    }
    return out, grads


@pytest.mark.parametrize("shape", W.MESHES)
def test_collectives_and_their_gradients(world, shape):
    got = world[shape]
    assert len(got) == shape[0] * shape[1]
    for rank, per_axis in enumerate(got):
        for axis, res in per_axis.items():
            assert res["coords"] == {"data": rank // shape[1], "model": rank % shape[1]}
            out, grads = _reference(shape, rank, axis)
            for k, want in out.items():
                np.testing.assert_allclose(res["out"][k], want, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{shape} rank {rank} {axis} {k}")
            # a bf16 psum sums in fp32 and rounds once
            bf = np.asarray(torch_bf16(sum(torch_bf16(W.inputs(1, r, (4, 6)))
                                           for r in _members(shape, rank, axis))))
            np.testing.assert_array_equal(res["out"]["psum_bf16"], bf)
            for k, want in grads.items():
                np.testing.assert_allclose(res["grad"][k], want, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{shape} rank {rank} {axis} grad {k}")
            assert res["gradcheck"] == {"f_g": True, "split_gather": True}


def torch_bf16(a):
    """a rounded to bf16 (as float32 numpy)."""
    import torch

    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def test_a_rank_loads_neither_jax_nor_the_jax_package():
    from repro_torch.runtime import mesh

    # two ranks: a world of one would run in this process, which has loaded jax
    assert mesh.launch(W.hygiene, (1, 2), device="cpu", threads=1, quiet=True,
                       timeout=WORLD_TIMEOUT) == []


def test_a_world_of_one_rank_runs_in_this_process():
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.runtime import mesh

    kept = torch.get_num_threads()
    assert mesh.launch(W.pid, (1, 1), device="cpu", threads=1, quiet=True) == \
        (os.getpid(), "1x1")
    assert not dist.is_initialized() and torch.get_num_threads() == kept


def test_mesh_shapes_transports_and_refusals():
    import torch

    from repro_torch.runtime import mesh

    assert mesh.parse_mesh("2x4") == (2, 4) and mesh.parse_mesh((1, 1)) == (1, 1)
    assert mesh.default_axes((2, 4)) == ("data", "model")
    assert mesh.default_axes((2, 2, 4)) == ("pod", "data", "model")
    for bad in ("2y4", "0x2", ""):
        with pytest.raises(ValueError):
            mesh.parse_mesh(bad)
    assert mesh.choose_transport("auto", "cpu", 4) == "gloo"
    for t in ("nccl", "gloo_staged"):
        with pytest.raises(ValueError, match="CPU runs gloo"):
            mesh.choose_transport(t, "cpu", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.choose_transport("auto", "cuda", 2)
    one = mesh.Mesh(("data", "model"), (1, 1), 0, "gloo", torch.device("cpu"), {})
    x = torch.ones(3)  # an axis of one rank: every collective is the identity
    assert one.psum(x, "model") is x and one.all_gather_tiled(x, "data") is x
    assert mesh.f(x, one) is x and mesh.g(x, one) is x and mesh.split(x, one, "model", 0) is x


# -- the sharding rules against JAX's ------------------------------------------


def _arch_ids():
    from repro_torch.configs import ARCH_IDS

    return ARCH_IDS


@functools.lru_cache(maxsize=None)
def _jax_axes_and_shapes(arch, smoke):
    from repro.configs import get_config, get_smoke_config
    from repro.models import model as JM
    from repro.models.layers import split_tree

    cfg = (get_smoke_config if smoke else get_config)(arch)
    tree = jax.eval_shape(lambda: JM.init(cfg, jax.random.PRNGKey(0)))
    vals, axes = split_tree(tree)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    flat_axes = jax.tree.leaves(axes, is_leaf=is_axes)
    return cfg, flat_axes, [tuple(v.shape) for v in jax.tree.leaves(vals)]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", _arch_ids())
def test_param_axes_are_jax_split_tree_axes(arch, smoke):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps
    from repro_torch.optim import sgd

    cfg = (get_smoke_config if smoke else get_config)(arch)
    _, jaxes, jshapes = _jax_axes_and_shapes(arch, smoke)
    axes = leaves(model.param_axes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    shapes = [tuple(t.shape) for t in leaves(steps.abstract_train_state(cfg, sgd(0.1))["params"])]
    assert axes == [tuple(a) for a in jaxes]
    assert shapes == jshapes


@pytest.mark.parametrize("arch", _arch_ids())
def test_spec_for_axes_and_batch_spec_are_jax_s(arch):
    from repro.runtime import dist, sharding as js
    from repro_torch.configs import get_config
    from repro_torch.runtime import sharding

    jcfg, jaxes, shapes = _jax_axes_and_shapes(arch, False)
    cfg = get_config(arch)
    rules, jrules = sharding.rules_for(cfg), js.rules_for(jcfg)
    assert rules == jrules
    for shape in JAX_MESHES:
        jmesh = dist.abstract_mesh(shape, ("data", "model"))
        sizes = dict(zip(("data", "model"), shape))
        for ax, shp in zip(jaxes, shapes):
            want = tuple(js.spec_for_axes(jmesh, ax, shp, jrules))
            assert sharding.spec_for_axes(sizes, ax, shp, rules) == want, (arch, shape, ax, shp)
            assert sharding.spec_for_axes(sizes, ax, None, rules) == \
                tuple(js.spec_for_axes(jmesh, ax, None, jrules))
        assert sharding.batch_spec(sizes, rules) == tuple(js.batch_spec(jmesh, jrules))
    pod = dist.abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    assert sharding.batch_spec({"pod": 2, "data": 2, "model": 4}, rules) == \
        tuple(js.batch_spec(pod, jrules))
    assert sharding.replicated() == tuple(jax.sharding.PartitionSpec())


def test_shard_and_unshard_cut_and_rebuild_a_tensor():
    import torch

    from repro_torch.runtime import sharding

    t = torch.arange(4 * 6, dtype=torch.float32).view(4, 6)
    for coords, want in (({"data": 1, "model": 0}, t[2:4, 0:3]),
                         ({"data": 0, "model": 1}, t[0:2, 3:6])):
        class M:  # a 2x2 mesh at coords
            def size(self, a):
                return 2

            def index(self, a):
                return coords[a]

        assert torch.equal(sharding.shard_tensor(t, ("data", "model"), M()), want)
        assert torch.equal(sharding.shard_tensor(t, (None, None), M()), t)
    assert torch.equal(sharding.unshard_tensor(t, ("data", "model"), None), t)


# -- optimizer state axes -----------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "kimi_k2_1t_a32b", "zamba2_1p2b"])
def test_state_axes_are_jax_s(arch):
    from repro.optim import optimizers as jopt
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.optim import optimizers as opt
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    _, jaxes, _ = _jax_axes_and_shapes(arch, True)
    cfg = get_smoke_config(arch)
    axes = model.param_axes(cfg)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import model as JM
    from repro.models.layers import split_tree

    jtree = split_tree(jax.eval_shape(lambda: JM.init(jsmoke(arch), jax.random.PRNGKey(0))))[1]
    for mk, jmk in ((lambda: opt.sgd(0.1), lambda: jopt.sgd(0.1)),
                    (lambda: opt.sgd(0.1, momentum=0.9), lambda: jopt.sgd(0.1, momentum=0.9)),
                    (lambda: opt.adamw(0.1), lambda: jopt.adamw(0.1)),
                    (lambda: opt.adafactor(0.1), lambda: jopt.adafactor(0.1))):
        o, jo = mk(), jmk()
        got = leaves(o.state_axes(axes), is_leaf=is_axes)
        want = [tuple(a) for a in jax.tree.leaves(jo.state_axes(jtree), is_leaf=is_axes)]
        assert got == want, o.name
        # the state's leaves, in order, take these axes
        like = steps.abstract_train_state(cfg, o)["opt"]
        assert [len(t.shape) for t in leaves(like)] == [len(a) for a in got]
