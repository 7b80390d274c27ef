"""Port parity: the dense LM (models/model.py, transformer.py, attention.py).

For the smoke configs of gemma_2b (MQA, GeGLU, embedding scale), olmo_1b
(MHA, nonparametric norm) and qwen3_32b (GQA, qk-norm) the JAX params
(`M.init`, numpy-mapped) cross with `convert.lm_params_from_numpy`, and
the port's forward, prefill and decode steps are held against JAX's at
1e-4 (the smoke configs compute in fp32).  JAX's forward runs with
attn_impl "pallas" (the TPU kernel in interpret mode) and "blockwise"; the
port runs K2's plain version (CPU tensors).  Greedy prefill + decode must
equal the argmax of the teacher-forced forward, the port's twin of
tests/test_serve.py::test_serve_greedy_matches_forward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, to_jax, to_torch

TOL = 1e-4
ARCHS = ["gemma_2b", "olmo_1b", "qwen3_32b"]
B, P, G = 2, 12, 7  # batch, prompt, generated tokens (G - 1 = 6 decode steps)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX cfg, JAX params, port cfg, port params, prompt tokens)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy

    jcfg = jax_smoke(arch)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    cfg = get_smoke_config(arch)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    return jcfg, vals, cfg, params, toks


def _M():
    from repro_torch.models import model

    return model


def test_smoke_configs_match_the_jax_ones():
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config

    for arch in ("gemma_2b", "olmo_1b", "granite_8b", "qwen3_32b"):
        for ours, theirs in ((get_config(arch), jax_config(arch)),
                             (get_smoke_config(arch), jax_smoke(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_counts() == theirs.param_counts()
    full = get_config("gemma-2b")
    assert full.cdtype == torch.bfloat16 and full.dtype == torch.float32
    assert full.resolved_head_dim == 256 and full.n_kv_heads == 1


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "phi3_vision_4p2b", "hubert_xlarge"])
def test_families_not_ported_raise(arch):
    from repro_torch.configs import get_config, get_smoke_config

    for fn in (get_config, get_smoke_config):
        with pytest.raises(NotImplementedError, match="ROADMAP section 1"):
            fn(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_jax_tree_and_shapes(arch):
    import jax

    jcfg, vals, cfg, _, _ = _setup(arch)
    ours = _M().init(cfg, seed=0, device="cpu")
    flat_j = {jax.tree_util.keystr(p): np.shape(v)
              for p, v in jax.tree_util.tree_flatten_with_path(vals)[0]}
    flat_t = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                flat_t[path + f"['{k}']"] = tuple(v.shape)
                assert v.dtype == torch.float32
    walk(ours, "")
    assert flat_t == flat_j
    hybrid = dataclasses.replace(cfg, family="hybrid")
    with pytest.raises(NotImplementedError, match="hybrid"):
        _M().init(hybrid, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_forward_matches_jax(arch, impl):
    from repro.models import model as JM

    jcfg, vals, cfg, params, toks = _setup(arch)
    want, _ = JM.forward(dataclasses.replace(jcfg, attn_impl=impl), vals, {"tokens": to_jax(toks)})
    got, aux = _M().forward(dataclasses.replace(cfg, attn_impl=impl), params,
                            {"tokens": to_torch(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, P, cfg.vocab)
    assert float(aux) == 0.0
    assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_impl_matches_kernel_impl(arch):
    _, _, cfg, params, toks = _setup(arch)
    dense, _ = _M().forward(dataclasses.replace(cfg, attn_impl="dense"), params,
                            {"tokens": to_torch(toks)})
    kern, _ = _M().forward(cfg, params, {"tokens": to_torch(toks)})
    assert_close(dense, kern, rtol=TOL, atol=TOL)


def _jax_serve(arch):
    """JAX prefill, then G - 1 greedy decode steps: (prefill logits, prefill
    cache, [(token fed, step logits)], final cache)."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    jcfg, vals, _, _, toks = _setup(arch)
    logits, pre = JM.prefill(jcfg, vals, {"tokens": to_jax(toks)})
    cache = jax.tree.map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part.astype(full.dtype),
                                                        (0,) * full.ndim),
        JM.init_cache(jcfg, B, P + G), pre)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    steps = []
    for i in range(G - 1):
        lg, cache = step(vals, cache, tok, jnp.asarray(P + i, jnp.int32))
        steps.append((np.array(tok), lg))
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    return logits, pre, steps, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    from repro_torch.launch.serve import _merge_prefill_cache

    _, _, cfg, params, toks = _setup(arch)
    jlogits, jpre, jsteps, jcache = _jax_serve(arch)
    logits, pre = _M().prefill(cfg, params, {"tokens": to_torch(toks)})
    assert_close(logits, jlogits, rtol=TOL, atol=TOL, what="prefill logits")
    for name in ("k", "v"):
        assert tuple(pre["layers"][name].shape) == (
            cfg.n_layers, B, P, cfg.n_kv_heads, cfg.resolved_head_dim)
        assert_close(pre["layers"][name], jpre["layers"][name], rtol=TOL, atol=TOL,
                     what=f"prefill cache {name}")
    cache = _merge_prefill_cache(cfg, _M().init_cache(cfg, B, P + G, device="cpu"), pre)
    assert len(jsteps) == G - 1 == 6
    for i, (tok, jlg) in enumerate(jsteps):  # the JAX tokens, fed to both
        lg, cache = _M().decode_step(cfg, params, cache, to_torch(tok), P + i)
        assert tuple(lg.shape) == (B, 1, cfg.vocab)
        assert_close(lg, jlg, rtol=TOL, atol=TOL, what=f"decode step {i}")
    for name in ("k", "v"):
        assert_close(cache["layers"][name], jcache["layers"][name], rtol=TOL, atol=TOL,
                     what=f"final cache {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_teacher_forced_forward(arch):
    from repro_torch.launch.serve import _merge_prefill_cache

    _, _, cfg, params, toks = _setup(arch)
    M = _M()
    logits, pre = M.prefill(cfg, params, {"tokens": to_torch(toks)})
    cache = _merge_prefill_cache(cfg, M.init_cache(cfg, B, P + G, device="cpu"), pre)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    gen = [tok]
    for i in range(G - 1):
        lg, cache = M.decode_step(cfg, params, cache, tok, P + i)
        tok = torch.argmax(lg[:, -1, :], dim=-1)[:, None]
        gen.append(tok)
    gen = torch.cat(gen, dim=1)
    full, _ = M.forward(cfg, params, {"tokens": torch.cat([to_torch(toks).long(), gen], dim=1)})
    greedy = torch.argmax(full[:, P - 1: P + G - 1, :], dim=-1)
    assert torch.equal(greedy, gen)
