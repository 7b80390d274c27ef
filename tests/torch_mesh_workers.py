"""Rank functions of the port's multi-rank tests (tests/test_torch_mesh.py,
tests/test_torch_sharded_train.py, tests/test_torch_moe_a2a.py,
tests/test_torch_mesh_coder.py, tests/test_torch_mesh_serve_dict.py,
tests/test_torch_fsdp.py, tests/test_torch_sequence_parallel.py,
tests/test_torch_hybrid_mesh.py, tests/test_torch_xlstm_mesh.py).

Each runs on every rank of a world that runtime/mesh.launch spawns (gloo,
CPU tensors), builds the meshes it needs over the world's first ranks,
and returns rank 0's results as numpy arrays and floats.  This module
imports torch and the port only: the ranks never load jax or the JAX
package (`hygiene` checks that from inside a rank).
"""

from __future__ import annotations

import sys
from unittest import mock

import numpy as np
import torch

from repro_torch.runtime import mesh as mesh_mod

MESHES = ((1, 2), (2, 1), (2, 2))


def inputs(seed: int, rank: int, shape) -> np.ndarray:
    """The float64 input of `rank` (numpy, from a seed)."""
    return np.random.default_rng([seed, rank]).standard_normal(shape)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


def _on_rank0(mesh, value):
    """Every mesh rank's value, gathered on mesh rank 0 (None elsewhere)."""
    got = mesh.all_gather_object(value)
    return got if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# The mesh's collectives (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def _collectives(mesh, axis: str) -> dict:
    r = mesh.rank
    x = _t(inputs(1, r, (4, 6)))
    out = {
        "psum": mesh.psum(x, axis), "pmax": mesh.pmax(x, axis),
        "all_gather0": mesh.all_gather_tiled(x, axis, 0),
        "all_gather1": mesh.all_gather_tiled(x, axis, 1),
        "psum_scatter0": mesh.psum_scatter_tiled(x, axis, 0),
        "psum_scatter1": mesh.psum_scatter_tiled(x, axis, 1),
        "all_to_all": mesh.all_to_all_tiled(x, axis),
        "psum_bf16": mesh.psum(x.to(torch.bfloat16), axis),
        "broadcast": mesh.broadcast(x),
    }
    n = mesh.size(axis)
    rep = _t(inputs(3, 0, (4, 6)))  # replicated over the mesh

    def grad_of(fn, x0, c):
        x0 = x0.clone().requires_grad_(True)
        y = fn(x0)
        (y * c).sum().backward()
        return x0.grad

    grads = {
        "all_gather": grad_of(lambda v: mesh_mod.all_gather(v, mesh, axis, 0), x,
                              _t(inputs(2, r, (4 * n, 6)))),
        "psum_scatter": grad_of(lambda v: mesh_mod.psum_scatter(v, mesh, axis, 0), x,
                                _t(inputs(2, r, (4 // n, 6)))),
        "all_to_all": grad_of(lambda v: mesh_mod.all_to_all(v, mesh, axis), x,
                              _t(inputs(2, r, (4, 6)))),
        "f": grad_of(lambda v: mesh_mod.f(v, mesh, axis), rep, _t(inputs(2, r, (4, 6)))),
        "g": grad_of(lambda v: mesh_mod.g(v, mesh, axis), x, _t(inputs(4, 0, (4, 6)))),
        "split": grad_of(lambda v: mesh_mod.split(v, mesh, axis, 1), rep,
                         _t(inputs(2, r, (4, 6 // n)))),
        "gather": grad_of(lambda v: mesh_mod.gather(v, mesh, axis, 1), x,
                          _t(inputs(4, 0, (4, 6 * n)))),
    }
    w = _t(inputs(5, r, (3,)))
    x3 = _t(inputs(6, 0, (3,))).requires_grad_(True)
    w4 = _t(inputs(5, r, (4,)))
    x4 = _t(inputs(6, 0, (4,))).requires_grad_(True)
    checks = {
        "f_g": torch.autograd.gradcheck(
            lambda v: mesh_mod.g(mesh_mod.f(v, mesh, axis) * w, mesh, axis), (x3,)),
        "split_gather": torch.autograd.gradcheck(
            lambda v: mesh_mod.gather(mesh_mod.split(v, mesh, axis, 0)
                                      * mesh_mod.split(w4, mesh, axis, 0), mesh, axis, 0),
            (x4,)),
    }
    return {"out": {k: _np(v) for k, v in out.items()},
            "grad": {k: _np(v) for k, v in grads.items()}, "gradcheck": checks,
            "coords": mesh.coords}


def collectives(mesh0) -> dict:
    """For each of MESHES and each axis: every rank's outputs, gradients
    and gradchecks (the references are computed by the test)."""
    results = {}
    for shape in MESHES:
        mesh = mesh_mod.make_mesh(shape)
        if mesh is None:
            continue
        per_axis = {a: _collectives(mesh, a) for a in ("data", "model")}
        got = _on_rank0(mesh, per_axis)
        if got is not None:
            results[shape] = got
    return results


def hygiene(mesh0) -> list:
    """Import every module of the sharded path in this rank; the jax and
    JAX-package modules then loaded."""
    import importlib

    for name in ("repro_torch.runtime.mesh", "repro_torch.runtime.sharding",
                 "repro_torch.models.sharding_hook", "repro_torch.models.moe_a2a",
                 "repro_torch.runtime.steps", "repro_torch.runtime.runner",
                 "repro_torch.launch.train", "repro_torch.checkpoint.manager",
                 "repro_torch.runtime.comm", "repro_torch.core.distributed",
                 "repro_torch.runtime.service", "repro_torch.launch.serve_dict"):
        importlib.import_module(name)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")


# ---------------------------------------------------------------------------
# Sharded training (tests/test_torch_sharded_train.py)
# ---------------------------------------------------------------------------


def _sharded_params(cfg, tree, mesh, opt):
    from repro_torch.convert import lm_params_shard_from_numpy
    from repro_torch.runtime import steps

    specs = steps.state_shardings(cfg, opt, mesh)["params"]
    return lm_params_shard_from_numpy(cfg, tree, mesh, "cpu"), specs


def _full(tree, specs, mesh):
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding

    return [_np(t) for t in leaves(sharding.unshard_tree(tree, specs, mesh))]


def _loss_and_grads(cfg, tree, batch, mesh, rules=None) -> dict:
    from repro_torch.models import model as M
    from repro_torch.models import sharding_hook as hook
    from repro_torch.optim import sgd
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.runtime import steps

    params, specs = _sharded_params(cfg, tree, mesh, sgd(0.0))
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    local = steps.batch_to_device(steps.data_shard(batch, mesh), "cpu")
    with hook.installed(mesh, rules):
        loss, metrics = M.loss_fn(cfg, params, local)
    grads = torch.autograd.grad(loss, flat)
    flat_specs = leaves(specs, is_leaf=lambda s: isinstance(s, tuple))
    grads = steps._average_over_data(mesh, grads, flat_specs)
    vals = torch.stack([loss.detach(), metrics["ce"].detach(), metrics["moe_aux"].detach()])
    for a in ("data",):
        vals = mesh.psum(vals, a) / mesh.size(a)
    full = _full(unflatten(params, grads), specs, mesh)
    return {"loss": float(vals[0]), "ce": float(vals[1]), "moe_aux": float(vals[2]),
            "grads": full}


def _steps(cfg, tree, batches, mesh, opt, rules=None) -> dict:
    from repro_torch.runtime import steps

    params, specs = _sharded_params(cfg, tree, mesh, opt)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = steps.make_train_step(cfg, opt, mesh, rules=rules)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _full(state["params"], specs, mesh)}


def sharded_train(mesh0, job: dict) -> dict:
    """Per arch and mesh of job["cases"]: the loss and gradient of one
    batch and three SGD steps (losses, params), at 2x2 also three AdamW
    steps (losses), from the same numpy params; then the runner's fault and replay at 2x2,
    checkpoints across meshes (job["ckpt"])."""
    from repro_torch.optim import adamw, sgd

    out = {}
    for name, case in job["cases"].items():
        cfg, tree, batches = case["cfg"], case["params"], case["batches"]
        for shape in case["meshes"]:
            mesh = mesh_mod.make_mesh(shape)
            if mesh is None:
                continue
            res = {"grad": _loss_and_grads(cfg, tree, batches[0], mesh),
                   "sgd": _steps(cfg, tree, batches, mesh, sgd(job["sgd_lr"]))}
            if shape == (2, 2):
                res["adamw"] = _steps(cfg, tree, batches, mesh, adamw(job["adamw_lr"]))
            if mesh.rank == 0:
                out[(name, shape)] = res
    out["ckpt"] = _checkpoints(job["ckpt"])
    out["slow_write"] = _slow_write(job["slow_write"])
    return out


def _runner(cfg, mesh, ckpt_dir, opt, fault_at=-1):
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    hit = {"done": False}

    def hook(step):
        if step == fault_at and not hit["done"]:
            hit["done"] = True
            raise RuntimeError(f"injected node failure at step {step}")

    return TrainRunner(cfg, mesh, opt, RunnerConfig(ckpt_dir, ckpt_every=2, log_every=1),
                       fault_hook=hook if fault_at >= 0 else None)


def _checkpoints(job: dict) -> dict:
    """At 2x2: 4 steps, a checkpoint every 2, a fault at 3 (restore 2,
    replay); the checkpoint of step 4 restored at 1x2, 2x1 and 1x1, each
    rank's shard against the file's whole tensors; the 1x1 checkpoint in
    job["from_1x1"] restored at 2x2 likewise."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding, steps

    cfg, batches = job["cfg"], job["batches"]
    opt = adamw(1e-3)
    like = steps.abstract_train_state(cfg, opt)
    res = {}
    mesh = mesh_mod.make_mesh((2, 2))
    runner = _runner(cfg, mesh, job["dir"], opt, fault_at=3)
    losses = []
    runner.run(lambda s: batches[s % len(batches)], 4,
               metrics_cb=lambda s, m: losses.append([s - 1, m["loss"]]))
    if mesh.rank == 0:
        res["losses"] = losses
        res["faults"] = len([e for e in runner.events if e["kind"] == "fault"])
        res["ckpt_steps"] = runner.ckpt.steps()

    def held(mesh, directory, step):
        """Every rank's restored shard equals its cut of the file's tree."""
        r = _runner(cfg, mesh, directory, opt)
        state = r.restore_or_init(step=step)
        whole = load_pytree(r.ckpt.path(step), like)
        specs = steps.state_shardings(cfg, opt, mesh)
        want = sharding.shard_tree(whole, specs, mesh)
        ok = all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(want)))
        ok = ok and int(state["step"]) == step
        got = mesh.all_gather_object(bool(ok))
        return all(got)

    for shape in ((1, 2), (2, 1), (1, 1), (2, 2)):
        m = mesh_mod.make_mesh(shape)
        if m is not None:
            ok = held(m, job["dir"], 4)
            if m.rank == 0:
                res[("from_2x2", shape)] = ok
    m = mesh_mod.make_mesh((2, 2))
    ok = held(m, job["from_1x1"], job["from_1x1_step"])
    if m.rank == 0:
        res[("from_1x1", (2, 2))] = ok
    return res


def _slow_write(job: dict) -> bool:
    """Checkpoint writes slower than the mesh groups' timeout (a 2x2 mesh
    whose groups time out after job["timeout_s"] seconds, rank 0's every
    write sleeping job["sleep_s"] first): an async save, a blocking save
    (which waits for the first write, then writes) and a restore.  True
    when every rank got its shard of step 2 back (a rank whose collective
    timed out raises instead)."""
    import datetime
    import time
    from unittest import mock

    from repro_torch.checkpoint import manager
    from repro_torch.runtime import sharding

    with mock.patch.object(mesh_mod, "GROUP_TIMEOUT",
                           datetime.timedelta(seconds=job["timeout_s"])):
        mesh = mesh_mod.make_mesh((2, 2))
    specs = {"b": (None,), "w": ("model", "data")}
    whole = {"b": torch.arange(3.0), "w": torch.arange(16.0).reshape(4, 4)}
    tree = sharding.shard_tree(whole, specs, mesh)
    write = manager.save_pytree

    def slow(path, t):
        time.sleep(job["sleep_s"])
        write(path, t)

    with mock.patch.object(manager, "save_pytree", slow):
        ck = manager.CheckpointManager(job["dir"], mesh=mesh, specs=specs)
        ck.save(1, tree, blocking=False)
        ck.save(2, tree, blocking=True)
        got, step = ck.restore(whole)
    ok = step == 2 and all(torch.equal(got[k], tree[k]) for k in whole)
    return all(mesh.all_gather_object(bool(ok)))


def pid(mesh0) -> tuple:
    """This rank's process id and its mesh."""
    import os

    return os.getpid(), mesh0.describe()


# ---------------------------------------------------------------------------
# The all-to-all MoE layer (tests/test_torch_moe_a2a.py)
# ---------------------------------------------------------------------------


# The a2a layer's specs with `embed` over `data` (FSDP), as JAX's
# apply_moe_a2a shards them on a mesh with a data axis.
FSDP_MOE_SPECS = {"router": ("data", None), "wi": ("model", "data", None),
                  "wg": ("model", "data", None), "wo": ("model", None, "data"),
                  "shared": {"wi": ("data", None), "wg": ("data", None), "wo": (None, "data")}}


def _moe_case(mesh, params_np, x_np, *, top_k, cf, wire, grads: bool, fsdp: bool = False) -> dict:
    from repro_torch.models.moe_a2a import apply_moe_a2a
    from repro_torch.pytree import leaves, unflatten
    from repro_torch.runtime import sharding, steps

    e = params_np["router"].shape[1]
    specs = {"router": (None, None), "wi": ("model", None, None), "wg": ("model", None, None),
             "wo": ("model", None, None)}
    if "shared" in params_np:
        specs["shared"] = {"wi": (None, None), "wg": (None, None), "wo": (None, None)}
    if fsdp:
        specs = {k: v for k, v in FSDP_MOE_SPECS.items() if k in params_np}
    full = {k: ({kk: _t(vv).float() for kk, vv in v.items()} if isinstance(v, dict)
                else _t(v).float()) for k, v in params_np.items()}
    params = sharding.shard_tree(full, specs, mesh)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(grads)
    x = steps.data_shard({"x": _t(x_np).float()}, mesh)["x"]
    with torch.enable_grad():
        out, aux = apply_moe_a2a(mesh, params, x, top_k=top_k, n_experts=e,
                                 capacity_factor=cf, wire_dtype=wire,
                                 specs=specs if fsdp else None)
    res = {"out": _np(mesh.all_gather_tiled(out.detach(), "data", 0)), "aux": float(aux.detach())}
    if grads:
        dp = mesh.size("data")
        loss = dp * torch.sum(out ** 2) + 0.01 * aux
        g = torch.autograd.grad(loss, flat)
        g = steps._average_over_data(mesh, g, leaves(specs, is_leaf=lambda s: isinstance(s, tuple)))
        res["grads"] = _full(unflatten(params, g), specs, mesh)
    return res


def moe_a2a(mesh0, job: dict) -> dict:
    """Per mesh of job["meshes"] and case of job["cases"]: the layer's
    output (gathered over data), aux and (with grads) the parameters'
    gradients of sum(out^2) + 0.01 aux, whole."""
    out = {}
    for shape in job["meshes"]:
        mesh = mesh_mod.make_mesh(shape)
        if mesh is None:
            continue
        for name, c in job["cases"].items():
            res = _moe_case(mesh, job["params"], job["x"], top_k=job["top_k"], cf=c["cf"],
                            wire=c["wire"], grads=c["grads"])
            if mesh.rank == 0:
                out[(name, shape)] = res
    return out


# ---------------------------------------------------------------------------
# The paper's engine across ranks (tests/test_torch_mesh_coder.py)
# ---------------------------------------------------------------------------


def _traffic(mesh) -> dict:
    return {a: list(c) for a, c in mesh.traffic.items()}


def _since(mesh, before: dict) -> dict:
    """Per axis [calls, bytes] this rank put on the wire since `before`."""
    return {a: [c[0] - before.get(a, [0, 0])[0], c[1] - before.get(a, [0, 0])[1]]
            for a, c in mesh.traffic.items() if c != before.get(a)}


def _ppermute_cases(mesh) -> dict:
    """Mesh.ppermute over `model` (4 ranks): a shift, a partial permutation
    with a self-pair, no pair at all; over `data` (1 rank) a self-pair and
    no pair; each rank's result and its traffic."""
    x = _t(inputs(7, mesh.rank, (3, 5)))
    cases = {"shift": ("model", [(i, (i + 1) % 4) for i in range(4)]),
             "partial": ("model", [(0, 2), (2, 0), (3, 3)]),
             "none": ("model", []),
             "self on a size-1 axis": ("data", [(0, 0)]),
             "none on a size-1 axis": ("data", [])}
    out = {}
    for name, (axis, pairs) in cases.items():
        before = _traffic(mesh)
        out[name] = (_np(mesh.ppermute(x, axis, pairs)), _since(mesh, before))
    return out


def flat_agent(coords: dict, axes, shape) -> int:
    """The flat agent index of mesh coordinates: outermost-major over every
    axis but `data`."""
    k = 0
    for a, n in zip(axes, shape):
        if a != "data":
            k = k * n + coords[a]
    return k


def mesh_coder(mesh0, job: dict) -> dict:
    """Every case of job["cases"] on its mesh over the world's first ranks:
    the coder on the mesh (one agent a rank) at job's inputs; each case's
    per-rank solve traffic, then the gathered per-agent solve, the
    gathered `solve`, `fit_batch` gathered whole, the scores and the step
    sizes.  Also the ppermute semantics on the (1, 4) mesh.  Rank 0's
    results, as numpy."""
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    out = {}
    meshes = {}
    for case in job["cases"].values():
        key = (tuple(case["shape"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = mesh_mod.make_mesh(*key)
    m14 = meshes.get(((1, 4), ("data", "model"))) or mesh_mod.make_mesh((1, 4))
    if m14 is not None:
        got = _on_rank0(m14, _ppermute_cases(m14))
        if got is not None:
            out["ppermute"] = got
    res, reg = make_task(job["task"], gamma=job["gamma"], delta=job["delta"])
    for name, case in job["cases"].items():
        mesh = meshes[(tuple(case["shape"]), tuple(case["axes"]))]
        if mesh is None:
            continue
        coder = DistributedSparseCoder(case["agents"], res, reg, DistConfig(**case["cfg"]),
                                       device="cpu", mesh=mesh)
        W, x = coder.shard(case["W"], job["x"])
        _, h = coder.shard(case["W"], job["h"])
        t0 = case.get("t0", 0)
        before = _traffic(mesh)
        nu_k, y_k = coder.solve(W, x, t0)
        traffic = _since(mesh, before)
        nu_g, y_g = coder.gather_solution(nu_k, y_k)
        nu_a, y_a = coder.solve_per_agent(W, x, t0)
        W2 = coder.gather(coder.fit_batch(W, x, job["mu_w"], t0))
        score = mesh.all_gather_tiled(coder.score(W, h, t0), "data", 0)
        mu = coder.adaptive_mu(W)
        halves = None
        if mesh.size("data") > 1:  # the planted fault: fit_batch without its data sum
            with mock.patch.object(coder, "_data_sum", lambda t: t):
                halves = coder.gather(coder.fit_batch(W, x, job["mu_w"], t0))
        per_rank = mesh.all_gather_object({"traffic": traffic, "agent": coder.agent_index,
                                           "coords": mesh.coords})
        if mesh.rank == 0:
            out[name] = {"nu": _np(nu_a), "y": _np(y_a), "nu0": _np(nu_g), "y_flat": _np(y_g),
                         "W": _np(W2), "score": _np(score), "mu": _np(mu),
                         "wire": coder.wire_bytes_per_iter(x.shape[0], x.shape[1]),
                         "ranks": per_rank}
            if halves is not None:
                out[name]["W_no_data_sum"] = _np(halves)
    return out


# ---------------------------------------------------------------------------
# The dictionary service on a mesh (tests/test_torch_mesh_serve_dict.py)
# ---------------------------------------------------------------------------


def _idle_stream(job: dict) -> bool:
    """A service on a 1x2 mesh whose groups time out after job["timeout_s"]
    seconds, its stream idle for job["sleep_s"] seconds between two bursts:
    True when every rank got through (a follower whose wait for the next
    request timed out raises instead)."""
    import datetime
    import time

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.service import DictionaryService, ServiceConfig, follow

    with mock.patch.object(mesh_mod, "GROUP_TIMEOUT",
                           datetime.timedelta(seconds=job["timeout_s"])):
        mesh = mesh_mod.make_mesh((1, 2))
    if mesh is None:
        return True
    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    coder = DistributedSparseCoder(2, res, reg, DistConfig(mode="graph", iters=10),
                                   device="cpu", mesh=mesh)
    W0 = coder.snapshot(job["W"])
    ok = True
    if mesh.rank == 0:
        with DictionaryService(coder, W0, ServiceConfig(micro_batch=4, max_wait_s=0.01)) as svc:
            first = [f.result(timeout=60) for f in svc.submit_many(job["x"][:4])]
            time.sleep(job["sleep_s"])
            second = [f.result(timeout=60) for f in svc.submit_many(job["x"][4:])]
        ok = len(first) + len(second) == len(job["x"]) and svc.stats()["fit_steps"] >= 1
    else:
        follow(coder, W0)
    return all(mesh.all_gather_object(bool(ok)))


def serve_dict_runs(mesh0, job: dict) -> dict:
    """launch/serve_dict's rank body (`_serve_ranks`, what `--transport`
    runs on each rank) for each argv of job["runs"] on its mesh over the
    world's first ranks, then the idle stream (job["idle"]); rank 0's
    results."""
    from repro_torch.launch import serve_dict

    out = {}
    for name, argv in job["runs"].items():
        args = serve_dict.parse_args(argv)
        st = serve_dict._setup(args)
        mesh = mesh_mod.make_mesh(st["dims"], st["axes"])
        if mesh is not None:
            got = serve_dict._serve_ranks(mesh, args)
            if mesh.rank == 0:
                out[name] = got
    out["idle"] = _idle_stream(job["idle"])
    return out


# ---------------------------------------------------------------------------
# Sharded serving (tests/test_torch_sharded_serve.py)
# ---------------------------------------------------------------------------


def _whole_over(mesh, t, dims: dict):
    """t gathered over each axis of `dims` ({axis: dim}) whose size is > 1."""
    for axis, dim in dims.items():
        t = mesh.all_gather_tiled(t, axis, dim)
    return t


def _serve_case(mesh, case: dict):
    """launch/serve's rank body (`_serve_ranks`, what `--mesh` runs on each
    rank) on `mesh` (None beyond it) for one case: its config and the JAX
    params crossed by convert; on mesh rank 0 the tokens, every step's
    logits and the cache, each gathered whole."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding

    cfg = case["cfg"]
    with mock.patch.object(serve, "_config", lambda args: cfg), \
            mock.patch.object(serve.M, "init", lambda c, seed, device: lm_params_from_numpy(
                c, case["params"], device=device)):
        run = serve._serve_ranks(mesh, case["args"], keep=True)
    if mesh is None:
        return None
    vocab = {"model": 1} if run["last_logits"].shape[-1] != cfg.vocab else {}
    rows = {"data": 0}
    logits = [_whole_over(mesh, lg, {**rows, **vocab})
              for lg in [run["last_logits"]] + run["step_logits"]]
    specs = M.cache_specs(cfg, mesh, case["args"]["batch"], run["max_len"])
    cache = sharding.unshard_tree(run["cache"], specs, mesh)
    layer0 = {name: t[0].clone() for name, t in next(iter(run["cache"].values())).items()}
    got = {"tokens": run["tokens"].numpy(), "logits": [_np(t) for t in logits],
           "cache": {s: {n: _np(t) for n, t in kv.items()} for s, kv in cache.items()},
           "layout": run["cache_layout"], "agree": run["tokens_agree_over_model"],
           "seq": M.seq_sharded(cfg, mesh, run["max_len"]),
           "local_cache_shape": tuple(next(iter(layer0.values())).shape),
           "local_cache": {s: {n: tuple(t.shape) for n, t in kv.items()}
                           for s, kv in run["cache"].items()}}
    return got if mesh.rank == 0 else None


def _argmax_ties(mesh, logits_np) -> np.ndarray:
    """steps.greedy_tokens over the rank's vocabulary range of the whole
    (B, V) logits; every model rank's tokens (on rank 0)."""
    from repro_torch.runtime import steps

    class Cfg:
        vocab = logits_np.shape[1]

    v_loc = logits_np.shape[1] // mesh.size("model")
    r = mesh.index("model")
    mine = _t(logits_np[:, r * v_loc:(r + 1) * v_loc])
    tok = steps.greedy_tokens(Cfg, mine, mesh)
    return _on_rank0(mesh, tok.numpy())


def _moe_decode_ffn(mesh, job: dict):
    """The MoE FFN of a decode step (transformer._moe_ffn, one group) on
    `mesh`: the rank's rows of job["x"] through layer 0's experts, the
    outputs gathered over `data` (on mesh rank 0)."""
    from repro_torch.convert import lm_params_shard_from_numpy
    from repro_torch.models import model as M
    from repro_torch.models import sharding_hook as hook
    from repro_torch.models import transformer

    cfg = job["cfg"]
    params = M.cast_params(cfg, lm_params_shard_from_numpy(cfg, job["params"], mesh, "cpu"))
    x = _t(job["x"]).float()
    b = x.shape[0] // mesh.size("data")
    mine = x[mesh.index("data") * b:(mesh.index("data") + 1) * b]
    with hook.installed(mesh):
        out, aux = transformer._moe_ffn(params["layers"][0]["moe"], mine, cfg, 1)
    out = mesh.all_gather_tiled(out, "data", 0)
    return {"out": _np(out), "aux": float(aux)} if mesh.rank == 0 else None


def sharded_serve(mesh0, job: dict) -> dict:
    """Each serve case of job["serve"] on its mesh, the vocab-parallel
    argmax on planted ties, the MoE decode FFN with drops, and the MoE
    loss and gradient where S does not divide the model axis (job
    ["train"]); rank 0's results."""
    out = {}
    for name, case in job["serve"].items():
        mesh = mesh_mod.make_mesh(case["mesh"])
        got = _serve_case(mesh, case)
        if got is not None:
            out[name] = got
    for shape in job["ties_meshes"]:
        mesh = mesh_mod.make_mesh(shape)
        if mesh is not None:
            got = _argmax_ties(mesh, job["ties"])
            if got is not None:
                out[("ties", shape)] = got
    for shape in job["moe_meshes"]:
        mesh = mesh_mod.make_mesh(shape)
        if mesh is not None:
            got = _moe_decode_ffn(mesh, job["moe"])
            if got is not None:
                out[("moe", shape)] = got
    for name, case in job["train"].items():
        mesh = mesh_mod.make_mesh(case["mesh"])
        if mesh is not None:
            got = _loss_and_grads(case["cfg"], case["params"], case["batch"], mesh)
            if mesh.rank == 0:
                out[("train", name)] = got
    return out


# ---------------------------------------------------------------------------
# FSDP of `embed` over `data` (tests/test_torch_fsdp.py)
# ---------------------------------------------------------------------------


def _adafactor_on_shards(mesh, job: dict) -> list:
    """Adafactor's updates of job["leaves"] cut by job["specs"] on `mesh`,
    from the gradients of each step of job["grads"]: the params gathered
    whole after each step (on every rank)."""
    from repro_torch.optim import adafactor
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding, steps

    specs = job["specs"]
    opt = adafactor(job["lr"])
    params = sharding.shard_tree({k: _t(v).float() for k, v in job["leaves"].items()}, specs,
                                 mesh)
    state = opt.init(params)
    shards = steps.shards_for(mesh, leaves(specs, is_leaf=lambda s: isinstance(s, tuple)))
    out = []
    for i, g in enumerate(job["grads"]):
        grads = sharding.shard_tree({k: _t(v).float() for k, v in g.items()}, specs, mesh)
        opt.update(grads, state, params, i, shards)
        out.append(_full(params, specs, mesh))
    return out


def fsdp_world(mesh0, job: dict) -> dict:
    """Per arch and mesh of job["cases"] (FSDP configs): the loss and
    gradient of one batch, three SGD and three AdamW steps, and with the
    case's "adafactor" three Adafactor steps; Adafactor's update on sharded
    leaves (job["adafactor_leaves"], at 2x2); the runner's fault, replay and
    checkpoints across meshes (job["ckpt"]); launch/serve's rank body per
    job["serve"] case; the a2a layer with FSDP-sharded experts
    (job["a2a"]).  Rank 0's results."""
    from repro_torch.optim import adafactor, adamw, sgd

    out = {}
    for name, case in job["cases"].items():
        cfg, tree, batches = case["cfg"], case["params"], case["batches"]
        for shape in case["meshes"]:
            mesh = mesh_mod.make_mesh(shape)
            if mesh is None:
                continue
            res = {"grad": _loss_and_grads(cfg, tree, batches[0], mesh),
                   "sgd": _steps(cfg, tree, batches, mesh, sgd(job["sgd_lr"])),
                   "adamw": _steps(cfg, tree, batches, mesh, adamw(job["adamw_lr"]))}
            if case.get("adafactor"):
                res["adafactor"] = _steps(cfg, tree, batches, mesh, adafactor(job["adafactor_lr"]))
            if mesh.rank == 0:
                out[(name, shape)] = res
    mesh = mesh_mod.make_mesh((2, 2))
    got = _adafactor_on_shards(mesh, job["adafactor_leaves"])
    if mesh.rank == 0:
        out["adafactor_leaves"] = got
    out["ckpt"] = _checkpoints(job["ckpt"])
    for name, case in job["serve"].items():
        got = _serve_case(mesh_mod.make_mesh(case["mesh"]), case)
        if got is not None:
            out[("serve", name)] = got
    a2a = job["a2a"]
    mesh = mesh_mod.make_mesh((2, 2))
    for name, c in a2a["cases"].items():
        res = _moe_case(mesh, a2a["params"], a2a["x"], top_k=a2a["top_k"], cf=c["cf"],
                        wire=c["wire"], grads=c["grads"], fsdp=True)
        if mesh.rank == 0:
            out[("a2a", name)] = res
    return out


# ---------------------------------------------------------------------------
# The sequence-parallel residual (tests/test_torch_sequence_parallel.py)
# ---------------------------------------------------------------------------


def _layouts(cfg, tree, batch, mesh) -> dict:
    """The loss and gradients of one batch under the config's rules and
    under {"seq": None}, each with the bytes remat keeps a layer on this
    rank (model.remat_saved) and the layout the rules give the residual."""
    from repro_torch.models import model as M
    from repro_torch.runtime.sharding import residual_seq_axis, rules_for

    out = {}
    for name, rules in (("sp", rules_for(cfg)), ("replicated", rules_for(cfg, {"seq": None}))):
        with M.remat_saved() as saved:
            got = _loss_and_grads(cfg, tree, batch, mesh, rules)
        out[name] = {**got, "saved": list(saved),
                     "axis": residual_seq_axis(mesh, rules, batch["tokens"].shape[1])}
    return out


def _prefills(cfg, tree, batch, mesh) -> dict:
    """model.prefill under the config's rules and under {"seq": None}: the
    last position's logits and layer 0's K/V, gathered whole."""
    from repro_torch.convert import lm_params_shard_from_numpy
    from repro_torch.models import model as M
    from repro_torch.models import sharding_hook as hook
    from repro_torch.runtime import steps
    from repro_torch.runtime.sharding import rules_for

    params = M.cast_params(cfg, lm_params_shard_from_numpy(cfg, tree, mesh, "cpu"))
    local = steps.data_shard(batch, mesh)
    out = {}
    for name, rules in (("sp", rules_for(cfg)), ("replicated", rules_for(cfg, {"seq": None}))):
        with torch.no_grad(), hook.installed(mesh, rules):
            logits, cache = M.prefill(cfg, params, local)
        vocab = {"model": 2} if logits.shape[-1] != cfg.vocab else {}
        kv = next(iter(cache.values()))
        heads = {"model": 2} if kv["k"].shape[3] != cfg.n_kv_heads else {}
        out[name] = {"logits": _np(_whole_over(mesh, logits[:, -1:], {"data": 0, **vocab})),
                     **{n: _np(_whole_over(mesh, t[0], {"data": 0, **heads}))
                        for n, t in kv.items()}}
    return out


def _planted_norms(cfg, tree, batch, mesh) -> dict:
    """The loss and gradients under the config's rules with the norms'
    scales applied to the rank's slice without the sum of their gradients
    over `model` (a planted fault)."""
    from repro_torch.models import sharding_hook as hook

    with mock.patch.object(hook, "seq_shared", lambda params: params):
        return _loss_and_grads(cfg, tree, batch, mesh)


def _rules_steps(cfg, tree, batches, mesh) -> dict:
    """Two SGD steps through steps.make_train_step(rules=): the config's
    rules, {"seq": None}, and the config's rules with the layout decision
    forced to replicated (the code path a replicated residual runs)."""
    from repro_torch.models import sharding_hook as hook
    from repro_torch.optim import sgd
    from repro_torch.runtime.sharding import rules_for

    out = {"sp": _steps(cfg, tree, batches, mesh, sgd(0.5)),
           "seq_none": _steps(cfg, tree, batches, mesh, sgd(0.5),
                              rules=rules_for(cfg, {"seq": None}))}
    with mock.patch.object(hook, "residual_seq_axis", lambda *args: None):
        out["forced"] = _steps(cfg, tree, batches, mesh, sgd(0.5))
    return out


def sequence_parallel(mesh0, job: dict) -> dict:
    """Per case of job["cases"]: `_layouts` on its mesh; job["planted"]'s
    planted norm fault, job["steps"]'s make_train_step(rules=) runs and
    job["prefill"]'s prefills; job["serve"] through launch/serve's rank
    body.  Rank 0's results."""
    out = {}
    for name, case in job["cases"].items():
        mesh = mesh_mod.make_mesh(case["mesh"])
        if mesh is None:
            continue
        got = _layouts(case["cfg"], case["params"], case["batch"], mesh)
        if mesh.rank == 0:
            out[name] = got
    for key, fn in (("planted", _planted_norms), ("steps", _rules_steps),
                    ("prefill", _prefills)):
        case = job[key]
        mesh = mesh_mod.make_mesh(case["mesh"])
        if mesh is None:
            continue
        got = fn(case["cfg"], case["params"], case["batch"], mesh)
        if mesh.rank == 0:
            out[key] = got
    got = _serve_case(mesh_mod.make_mesh(job["serve"]["mesh"]), job["serve"])
    if got is not None:
        out["serve"] = got
    return out


# ---------------------------------------------------------------------------
# The hybrid and xlstm families on a mesh (tests/test_torch_hybrid_mesh.py,
# tests/test_torch_xlstm_mesh.py)
# ---------------------------------------------------------------------------


def _contiguous_in_proj(specs):
    """A param spec tree with Mamba2's in_proj cut in contiguous chunks
    (its `Segmented` parts made plain axis names)."""
    if isinstance(specs, dict):
        return {k: tuple(None if p is None else str(p) for p in v) if k == "in_proj"
                else _contiguous_in_proj(v) for k, v in specs.items()}
    return specs


def _planted(fault: str):
    """The patch that plants `fault` in the mixers on a mesh."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding_hook as hook

    def rank_part(t, dim):
        c = t.shape[dim] // hook.model_size()
        return t.narrow(dim, hook.model_index() * c, c)

    if fault == "norm sum through g":
        return mock.patch.object(hook, "model_sum", hook.leave_model)
    if fault == "gates through g":
        return mock.patch.object(hook, "head_scatter",
                                 lambda x, dim: rank_part(hook.leave_model(x), dim))
    if fault == "f_bias without f":
        return mock.patch.object(hook, "model_part", lambda t: rank_part(t, 0))
    if fault == "in_proj cut contiguously":
        specs_of = M.param_specs
        return mock.patch.object(M, "param_specs",
                                 lambda cfg, mesh: _contiguous_in_proj(specs_of(cfg, mesh)))
    raise KeyError(fault)


def _segmented_cut(cfg, tree, mesh) -> dict:
    """Every rank's shard of layer 0's in_proj, conv_w and conv_b (cut by
    param_specs), and whether every leaf's shard gathers back to the
    whole bit for bit."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves
    from repro_torch.runtime import sharding

    whole = lm_params_from_numpy(cfg, tree, "cpu")
    specs = M.param_specs(cfg, mesh)
    mine = sharding.shard_tree(whole, specs, mesh)
    back = sharding.unshard_tree(mine, specs, mesh)
    ok = all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(whole)))
    parts = {k: _np(mine["mamba"]["mixer"][k][0]) for k in ("in_proj", "conv_w", "conv_b")}
    got = mesh.all_gather_object({"coords": mesh.coords, "parts": parts, "ok": ok})
    return got if mesh.rank == 0 else None


def _data_traffic(cfg, tree, batches: dict, mesh) -> dict:
    """One SGD step a sequence length of `batches` ({S: batch}): the step's
    [collectives, bytes] over each axis (mesh.step_traffic)."""
    from repro_torch.optim import sgd
    from repro_torch.runtime import steps

    out = {}
    for s, batch in batches.items():
        params, _ = _sharded_params(cfg, tree, mesh, sgd(0.1))
        state = {"params": params, "opt": {}, "step": torch.zeros((), dtype=torch.int32)}
        steps.make_train_step(cfg, sgd(0.1), mesh)(state, batch)
        out[s] = {a: list(c) for a, c in mesh.step_traffic.items()}
    return out


def recurrent_mesh(mesh0, job: dict) -> dict:
    """The hybrid or xlstm family on meshes over the world's first ranks:
    job["layouts"]' loss and gradients under both residual layouts
    (`_layouts`), job["steps"]' optimizer runs, job["planted"]'s faults,
    job["serve"]'s serves through launch/serve's rank body, and where
    given the segmented cut (job["cut"]), the runner's checkpoints
    (job["ckpt"]) and a step's traffic at two sequence lengths
    (job["traffic"]).  Rank 0's results."""
    from repro_torch.optim import adafactor, adamw, sgd

    out = {}

    def each(cases, fn):
        for name, case in cases.items():
            mesh = mesh_mod.make_mesh(case["mesh"])
            if mesh is None:
                continue
            got = fn(case, mesh)
            if mesh.rank == 0:
                out[name] = got

    each({("layouts", n): c for n, c in job.get("layouts", {}).items()},
         lambda c, mesh: _layouts(c["cfg"], c["params"], c["batch"], mesh))
    opts = {"sgd": lambda: sgd(job["sgd_lr"]), "adamw": lambda: adamw(job["adamw_lr"]),
            "adafactor": lambda: adafactor(job["adafactor_lr"])}
    each({("steps", n): c for n, c in job.get("steps", {}).items()},
         lambda c, mesh: {o: _steps(c["cfg"], c["params"], c["batches"], mesh, opts[o]())
                          for o in c["opts"]})

    def planted(c, mesh):
        with _planted(c["fault"]):
            return _loss_and_grads(c["cfg"], c["params"], c["batch"], mesh)

    each({("planted", n): c for n, c in job.get("planted", {}).items()}, planted)
    for name, case in job.get("serve", {}).items():
        got = _serve_case(mesh_mod.make_mesh(case["mesh"]), case)
        if got is not None:
            out[("serve", name)] = got
    if "cut" in job:
        c = job["cut"]
        got = _segmented_cut(c["cfg"], c["params"], mesh_mod.make_mesh(c["mesh"]))
        if got is not None:
            out["cut"] = got
    if "traffic" in job:
        each({"traffic": job["traffic"]},
             lambda c, mesh: _data_traffic(c["cfg"], c["params"], c["batches"], mesh))
    if "ckpt" in job:
        out["ckpt"] = _checkpoints(job["ckpt"])
    return out
