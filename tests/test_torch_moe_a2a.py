"""The port's all-to-all expert-parallel MoE (models/moe_a2a.py) against the
JAX package's `apply_moe_a2a` on the same mesh shapes.

JAX runs on a forced four-device CPU mesh in one module-scoped subprocess
(as tests/test_moe_a2a.py runs it); the port in one module-scoped world of
four gloo ranks; both from the same numpy params (8 experts of d_ff 16 at
d 32, top-2, a shared expert) and input (4 x 16 tokens), at 1x2 and 2x2:

  * the native wire at capacity factor 1.25, where tokens are dropped:
    output and aux at FWD_RTOL, and the gradients of sum(out^2) + 0.01 aux
    against jax.grad of the same, at GRAD_RTOL;
  * the int8 wire (capacity 4.0): against JAX's int8 output at Q8_RTOL,
    and against moe_ref within JAX's own 0.05 (tests/test_moe_a2a.py);
  * capacity 4.0 (nothing dropped), native: output against moe_ref and
    JAX's, gradients against jax.grad and against the port's one-device
    capacity dispatch (apply_moe, 2 groups), as tests/test_moe_a2a.py
    holds JAX's a2a against its gather path.
"""

import functools
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from conftest import REPO, subprocess_env

WORLD_TIMEOUT = 300
FWD_RTOL, GRAD_RTOL, Q8_RTOL = 1e-5, 1e-5, 1e-2
MESHES = ((1, 2), (2, 2))
D, F, E, TOP_K = 32, 16, 8, 2
CASES = {"native": {"cf": 1.25, "wire": "native", "grads": True},
         "int8": {"cf": 4.0, "wire": "int8", "grads": False},
         "wide": {"cf": 4.0, "wire": "native", "grads": True}}

_JAX = """
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.models.moe_a2a import apply_moe_a2a

inp = np.load({path!r} + "/in.npz")
params = {{k: jnp.asarray(inp[k]) for k in ("router", "wi", "wg", "wo")}}
params["shared"] = {{k: jnp.asarray(inp["shared_" + k]) for k in ("wi", "wg", "wo")}}
x = jnp.asarray(inp["x"])
cases = {cases!r}
out = {{}}
for shape in {meshes!r}:
    mesh = make_mesh(shape, ("data", "model"))
    tag = "x".join(map(str, shape))
    for name, c in cases.items():
        fn = lambda p, xx: apply_moe_a2a(mesh, p, xx, top_k={top_k}, n_experts={e},
                                         capacity_factor=c["cf"], wire_dtype=c["wire"])
        with mesh:
            o, a = jax.jit(fn)(params, x)
            out[f"{{tag}}/{{name}}/out"] = np.asarray(o)
            out[f"{{tag}}/{{name}}/aux"] = np.asarray(a)
            if c["grads"]:
                g = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, x)[0] ** 2) + 0.01 * fn(p, x)[1]))(
                    params)
                for i, leaf in enumerate(jax.tree.leaves(g)):
                    out[f"{{tag}}/{{name}}/grad{{i}}"] = np.asarray(leaf)
np.savez({path!r} + "/out.npz", **out)
print("OK")
"""


def _inputs():
    rng = np.random.default_rng(3)
    p = {"router": rng.standard_normal((D, E)) / D ** 0.5,
         "wi": rng.standard_normal((E, D, F)) / D ** 0.5,
         "wg": rng.standard_normal((E, D, F)) / D ** 0.5,
         "wo": rng.standard_normal((E, F, D)) / F ** 0.5,
         "shared": {"wi": rng.standard_normal((D, F)) / D ** 0.5,
                    "wg": rng.standard_normal((D, F)) / D ** 0.5,
                    "wo": rng.standard_normal((F, D)) / F ** 0.5}}
    # a direction that every token shares and experts 0 and 1 (model rank
    # 0's) prefer: the routing is skewed, so capacity 1.25 drops tokens
    u = rng.standard_normal(D)
    u /= np.linalg.norm(u)
    p["router"][:, :2] += 2.0 * u[:, None]
    p = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()} if isinstance(v, dict)
             else v.astype(np.float32)) for k, v in p.items()}
    x = rng.standard_normal((4, 16, D)) + 1.5 * u
    return p, x.astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("a2a")
    params, x = _inputs()
    np.savez(path / "in.npz", x=x, **{k: v for k, v in params.items() if k != "shared"},
             **{"shared_" + k: v for k, v in params["shared"].items()})
    code = _JAX.format(path=str(path), cases=CASES, meshes=MESHES, top_k=TOP_K, e=E)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=subprocess_env(4), cwd=str(REPO), capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return dict(np.load(pathlib.Path(path) / "out.npz"))


@pytest.fixture(scope="module")
def port_side():
    from repro_torch.runtime import mesh

    params, x = _inputs()
    job = {"meshes": MESHES, "cases": CASES, "params": params, "x": x, "top_k": TOP_K}
    return mesh.launch(W.moe_a2a, (2, 2), device="cpu", threads=1, quiet=True, args=(job,),
                       timeout=WORLD_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _one_device():
    """moe_ref's output, and the port's one-device capacity dispatch at
    capacity 4.0: output and gradients of sum(out^2) + 0.01 aux."""
    from repro_torch.models.moe import apply_moe, moe_ref
    from repro_torch.pytree import leaves

    params, x = _inputs()
    p = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in params.items()}
    xt = torch.from_numpy(x)
    ref = moe_ref(p, xt, top_k=TOP_K).numpy()
    flat = leaves(p)
    for t in flat:
        t.requires_grad_(True)
    out, aux = apply_moe(p, xt, top_k=TOP_K, n_groups=2, capacity_factor=4.0)
    grads = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux, flat)
    return ref, out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


def _jax_grads(jax_side, tag, name):
    n = len([k for k in jax_side if k.startswith(f"{tag}/{name}/grad")])
    return [jax_side[f"{tag}/{name}/grad{i}"] for i in range(n)]


@pytest.mark.parametrize("shape", MESHES)
def test_native_wire_with_drops_matches_jax(jax_side, port_side, shape):
    tag = "x".join(map(str, shape))
    got = port_side[("native", shape)]
    ref, _, _ = _one_device()
    assert float(np.abs(jax_side[f"{tag}/native/out"] - ref).max()) > 1e-2  # tokens dropped
    _close(got["out"], jax_side[f"{tag}/native/out"], FWD_RTOL, f"{tag} out")
    assert abs(got["aux"] - float(jax_side[f"{tag}/native/aux"])) <= \
        FWD_RTOL * abs(float(jax_side[f"{tag}/native/aux"]))
    jg = _jax_grads(jax_side, tag, "native")
    assert len(jg) == len(got["grads"]) == 7
    for i, (g, w) in enumerate(zip(got["grads"], jg)):
        _close(g, w, GRAD_RTOL, f"{tag} grad {i}")


@pytest.mark.parametrize("shape", MESHES)
def test_int8_wire_matches_jax_and_the_reference(jax_side, port_side, shape):
    tag = "x".join(map(str, shape))
    got = port_side[("int8", shape)]["out"]
    ref, _, _ = _one_device()
    _close(got, jax_side[f"{tag}/int8/out"], Q8_RTOL, f"{tag} int8 out")
    assert float(np.abs(got - ref).max()) / float(np.abs(ref).max()) < 0.05  # two q8 hops
    assert float(np.abs(got - ref).max()) > 0.0  # the wire did quantize


@pytest.mark.parametrize("shape", MESHES)
def test_without_drops_matches_the_reference_and_the_one_device_path(jax_side, port_side,
                                                                      shape):
    tag = "x".join(map(str, shape))
    got = port_side[("wide", shape)]
    ref, one_out, one_grads = _one_device()
    _close(got["out"], ref, FWD_RTOL, f"{tag} vs moe_ref")
    _close(got["out"], one_out, FWD_RTOL, f"{tag} vs apply_moe")
    _close(got["out"], jax_side[f"{tag}/wide/out"], FWD_RTOL, f"{tag} vs jax")
    for i, (g, w, j) in enumerate(zip(got["grads"], one_grads,
                                      _jax_grads(jax_side, tag, "wide"))):
        _close(g, w, GRAD_RTOL, f"{tag} grad {i} vs apply_moe")
        _close(g, j, GRAD_RTOL, f"{tag} grad {i} vs jax")


def test_q8_codes_as_jax_quantize_q8():
    """_q8 with fp16 scales is dist.quantize_q8(x, axis, float16), a slice
    of zeros included."""
    import jax.numpy as jnp

    from repro.runtime import dist
    from repro_torch.models.moe_a2a import _q8

    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0.0
    for axis in (-1, 0):
        q, s = _q8(torch.from_numpy(x), axis)
        jq, js = dist.quantize_q8(jnp.asarray(x), axis=axis, scale_dtype=jnp.float16)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        keep = np.asarray(js).astype(np.float32) > 0
        keep = np.broadcast_to(keep, x.shape)
        np.testing.assert_array_equal(q.numpy()[keep], np.asarray(jq)[keep])
        assert (q.numpy()[~keep] == 0).all()
