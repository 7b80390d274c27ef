"""Port parity: dense-LM training (models/model.loss_fn, runtime/steps,
runtime/runner, convert's train state, launch/train, the token stream)
against the JAX package on the CPU.

  * TokenStream, lm_batches and launch/train.make_batches bit for bit;
  * loss_fn and its gradient on the olmo, gemma, qwen3, phi3_vision (the
    text loss after the image tokens), hubert (masked prediction) and
    xlstm (K3's plain version with its BPTT backward) smoke configs, remat
    on and off, against jax.value_and_grad(loss_fn): loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest |value| (of a
    sibling's for a leaf whose exact gradient is zero, ZERO_GRAD_LEAVES);
  * three train steps against JAX's jitted make_train_step from one state
    (convert.train_state_from_numpy): SGD params within 1e-4 of each leaf's
    largest |value| and losses within 1e-5 relative; AdamW losses within
    1e-5 relative and the updates on the scale of lr (ADAMW_TYPICAL,
    ADAMW_MAX: m_hat / sqrt(v_hat) maps a gradient of any size to about
    +-1);
  * the prefill and decode steps against JAX's (greedy tokens equal);
  * the runner: a run with injected faults replays to the uninterrupted
    run's losses and params bit for bit, resume continues bit for bit,
    rescale restores the latest step, straggler events, max_restarts, and
    the refusals (a mesh other than 1x1, an xlstm depth of partial groups);
  * the CLI with --device cpu, a fault and a rescale (olmo, the MoE
    configs, xlstm), and its refusals.
JAX runs single-device (jax.jit), no subprocess.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import ZERO_GRAD_LEAVES, assert_close, one_torch_thread  # noqa: F401

ARCHS = ["olmo_1b", "gemma_2b", "qwen3_32b", "phi3_vision_4p2b", "hubert_xlarge", "xlstm_1p3b"]
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
# AdamW's updates after three steps, in units of lr: all but 1e-3 of the
# elements within ADAMW_TYPICAL, none past ADAMW_MAX.  m_hat / sqrt(v_hat)
# maps a gradient of any size to about +-1, so where an element's gradients
# are small against its leaf's largest (sqrt(v) a few % of the leaf's) a
# gradient difference at GRAD_TOL's level moves its update by a few % of lr
# (3 of 16384 elements of a wq stack here, up to 0.024 lr; 0.060 lr card
# against CPU, chip_smoke.py); a flipped or wrong update moves it by
# order lr.
ADAMW_TYPICAL, ADAMW_MAX = 1e-3, 0.5
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    from repro.configs import get_smoke_config
    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(get_smoke_config(arch), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _tokens(cfg, seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _batch(cfg):
    """The loss tests' batch: B x S tokens from seed 1; vlm and audio the
    training CLI's batch of S positions (make_batches, step 1)."""
    if cfg.family in ("vlm", "audio"):
        from repro_torch.launch.train import make_batches

        return make_batches(cfg, B, S, seed=0)(1)
    return {"tokens": _tokens(cfg)}


def _n_loss_tokens(cfg, batch) -> float:
    if cfg.family == "audio":
        return float(batch["mask"].sum())
    return B * (batch["tokens"].shape[1] - 1)


def _port_params(cfg, tree):
    from repro_torch.convert import lm_params_from_numpy

    return lm_params_from_numpy(cfg, tree, device="cpu")


# -- data ---------------------------------------------------------------------


def test_token_stream_is_the_jax_stream_bit_for_bit():
    from repro.data import synthetic as jd
    from repro.launch.train import make_batches as jax_make_batches
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic as td
    from repro_torch.launch.train import make_batches

    for vocab, seed, branching in ((256, 0, 32), (1024, 3, 8)):
        js = jd.TokenStream(vocab, seed=seed, branching=branching)
        ts = td.TokenStream(vocab, seed=seed, branching=branching)
        for host in (0, 5):
            for a, b in zip(js.batches(3, 40, 2, host_index=host),
                            ts.batches(3, 40, 2, host_index=host)):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
    for a, b in zip(jd.lm_batches(300, 2, 9, 3, seed=4), td.lm_batches(300, 2, 9, 3, seed=4)):
        np.testing.assert_array_equal(a, b)
    jf = jax_make_batches(jax_smoke("olmo_1b"), 4, 32, seed=2)
    tf = make_batches(get_smoke_config("olmo_1b"), 4, 32, seed=2)
    for step in (0, 7):
        np.testing.assert_array_equal(np.asarray(jf(step)["tokens"]), tf(step)["tokens"])


# -- loss and gradient --------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, remat, one_torch_thread):  # noqa: F811
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.pytree import leaves

    jcfg = dataclasses.replace(jax_smoke(arch), remat=remat)
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    tree = _jax_params(arch)
    batch = _batch(cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    params = _port_params(cfg, tree)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= LOSS_RTOL * abs(float(jm["ce"]))
    assert float(metrics["n_tokens"]) == float(jm["n_tokens"]) == _n_loss_tokens(cfg, batch) > 0
    assert float(metrics["moe_aux"]) == 0.0
    named = {jax.tree_util.keystr(k): np.asarray(w)
             for k, w in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert len(named) == len(grads)
    for g, (name, w) in zip(grads, named.items()):
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(named[ZERO_GRAD_LEAVES.get(name, name)]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


def test_remat_reruns_each_layer_forward_in_the_backward(monkeypatch):
    """With cfg.remat each layer's attention runs twice per step (forward and
    the backward's recompute), without it once; the gradients agree."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model
    from repro_torch.pytree import leaves

    calls = []
    real = ops.FlashAttention.forward

    def counting(ctx, *a):
        calls.append(1)
        return real(ctx, *a)

    monkeypatch.setattr(ops.FlashAttention, "forward", staticmethod(counting))
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(get_smoke_config("olmo_1b"), remat=remat)
        params = model.init(cfg, 0, "cpu")
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        calls.clear()
        loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_tokens(cfg))})
        grads[remat] = torch.autograd.grad(loss, flat)
        assert len(calls) == (2 if remat else 1) * cfg.n_layers
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw", "adafactor"])
def test_a_train_step_leaves_no_reference_cycle(opt_name):
    """Once the caller drops a train state, its tensors are freed at once,
    not when the cyclic garbage collector next runs: the tree walks and the
    optimizer's walk hold no self-referential closure (on the card a
    lingering state or a step's gradients held device memory for the next
    phase, kimi-k2's 37.5 GB cut among them)."""
    import gc
    import weakref

    from repro_torch import optim
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches
    from repro_torch.runtime import steps

    cfg = get_smoke_config("granite_moe_1b_a400m")
    make = {"sgd": lambda: optim.sgd(0.1), "adamw": lambda: optim.adamw(1e-3),
            "adafactor": lambda: optim.adafactor(1e-3)}[opt_name]
    batch = make_batches(cfg, 2, 16)(0)

    def one_step():
        state = steps.init_train_state(cfg, make(), 0, "cpu")
        state, _ = steps.make_train_step(cfg, make())(state, batch)
        return [weakref.ref(t) for t in (state["params"]["embed"]["table"],
                                         state["params"]["layers"]["moe"]["wi"])]

    one_step()  # the process's first step makes PyTorch's one-time objects
    gc.collect()
    gc.disable()
    try:
        assert all(r() is None for r in one_step())
    finally:
        gc.enable()


def test_loss_fn_refuses_families_it_cannot_train():
    """Every family of the registry trains (xlstm, the last refused, gives a
    finite loss whose gradient reaches its sLSTM weights); what loss_fn
    still refuses is what the port does not run: a family outside the
    registry, an xlstm depth that is not whole groups."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model

    cfg = get_smoke_config("xlstm_1p3b")
    params = model.init(cfg, 0, "cpu")
    r_z = params["slstm"]["mixer"]["r_z"].requires_grad_(True)
    loss, metrics = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_tokens(cfg))})
    assert bool(torch.isfinite(loss)) and float(metrics["n_tokens"]) == B * (S - 1)
    (g,) = torch.autograd.grad(loss, [r_z])
    assert all(float(g[i].abs().max()) > 0 for i in range(g.shape[0]))
    tokens = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="slstm_every"):
        model.loss_fn(dataclasses.replace(cfg, n_layers=3), {}, tokens)
    with pytest.raises(KeyError, match="unknown family"):
        model.loss_fn(dataclasses.replace(cfg, family="rwkv"), {}, tokens)


# -- train steps ----------------------------------------------------------------


def _jax_state_and_step(arch, opt):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.runtime import steps as JS

    jcfg = jax_smoke(arch)
    state = JS.init_train_state(jcfg, opt, jax.random.PRNGKey(0))
    return state, jax.jit(JS.make_train_step(jcfg, opt))


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_three_train_steps_match_jax(which):
    from repro.optim import adamw as jadamw, sgd as jsgd
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.launch.train import make_batches
    from repro_torch.optim import adamw, sgd
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    lr = 0.5 if which == "sgd" else 1e-3
    jopt, topt = (jsgd(lr), sgd(lr)) if which == "sgd" else (jadamw(lr), adamw(lr))
    cfg = get_smoke_config("olmo_1b")
    jstate, jstep = _jax_state_and_step("olmo_1b", jopt)
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    step = steps.make_train_step(cfg, topt)
    batches = make_batches(cfg, 4, 24, seed=0)
    p0 = [np.asarray(x) for x in jax.tree.leaves(jstate["params"])]
    for i in range(3):
        batch = batches(i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert state["step"].dtype == torch.int32
    back = train_state_to_numpy(state)
    for got, want, start in zip(jax.tree.leaves(back["params"]),
                                jax.tree.leaves(jstate["params"]), p0):
        want = np.asarray(want)
        if which == "sgd":
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)
        else:  # the three updates, on the scale of lr
            d = np.abs((got - start) - (want - start))
            assert float(d.max()) <= ADAMW_MAX * lr, float(d.max()) / lr
            assert float(np.mean(d > ADAMW_TYPICAL * lr)) <= 1e-3
    assert len(leaves(state["opt"])) == len(jax.tree.leaves(jstate["opt"]))


def test_prefill_and_decode_steps_match_jax():
    from repro.configs import get_smoke_config as jax_smoke
    from repro.runtime import steps as JS
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.runtime import steps

    cfg, jcfg = get_smoke_config("olmo_1b"), jax_smoke("olmo_1b")
    tree = _jax_params("olmo_1b")
    toks = _tokens(cfg, b=2, s=10)
    jlast, jcache = JS.make_prefill_step(jcfg)(jax.tree.map(jnp.asarray, tree),
                                                {"tokens": jnp.asarray(toks)})
    params = model.cast_params(cfg, _port_params(cfg, tree))
    last, cache = steps.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert tuple(last.shape) == (2, 1, cfg.vocab)
    assert_close(last, jlast, rtol=1e-4, atol=1e-4)
    full = model.init_cache(cfg, 2, 12, device="cpu")
    for name in ("k", "v"):
        full["layers"][name][:, :, :10] = cache["layers"][name]
    jfull = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0))), jcache)
    tok = last.argmax(-1).to(torch.int32)
    assert torch.equal(tok, torch.from_numpy(np.array(jnp.argmax(jlast, -1), np.int32)))
    nxt, _ = steps.make_decode_step(cfg)(params, full, tok, 10)
    jnxt, _ = JS.make_decode_step(jcfg)(jax.tree.map(jnp.asarray, tree), jfull,
                                         jnp.asarray(tok.numpy()), 10)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_train_state_converts_both_ways_for_adamw_and_adafactor():
    from repro.optim import adafactor as jadafactor, adamw as jadamw
    from repro.runtime import steps as JS
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.optim import adafactor, adamw
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    cfg = get_smoke_config("gemma_2b")
    for jopt, topt in ((jadamw(1e-3), adamw(1e-3)), (jadafactor(1e-3), adafactor(1e-3))):
        js = jax.tree.map(np.asarray, JS.init_train_state(jax_smoke("gemma_2b"), jopt,
                                                           jax.random.PRNGKey(0)))
        state = train_state_from_numpy(cfg, js, device="cpu")
        like = steps.abstract_train_state(cfg, topt)
        assert [tuple(t.shape) for t in leaves(state)] == [tuple(t.shape) for t in leaves(like)]
        assert all(t.device.type == "meta" for t in leaves(like))
        back = train_state_to_numpy(state)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
            np.testing.assert_array_equal(a, b)


# -- the runner -------------------------------------------------------------------


def _runner(tmp_path, name, hook=None, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    cfg = get_smoke_config("olmo_1b")
    rc = RunnerConfig(str(tmp_path / name), **{"ckpt_every": 5, **kw})
    return TrainRunner(cfg, (1, 1), adamw(1e-3), rc, device="cpu", fault_hook=hook)


def _batches():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches

    return make_batches(get_smoke_config("olmo_1b"), 4, 32)


def _bitwise(a, b):
    from repro_torch.pytree import leaves

    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_fault_recovery_replays_bit_for_bit(tmp_path, one_torch_thread):  # noqa: F811
    """tests/test_runner.py::test_fault_recovery_and_replay_determinism on
    the port, exactly: faults at steps 7 and 9 restore step 5 and replay."""
    s1, h1 = _runner(tmp_path, "clean").run(_batches(), 12)
    fail_at = {7: True, 9: True}

    def hook(step):
        if fail_at.pop(step, False):
            raise RuntimeError(f"injected failure at {step}")

    r2 = _runner(tmp_path, "faulty", hook)
    s2, h2 = r2.run(_batches(), 12)
    faults = [e for e in r2.events if e["kind"] == "fault"]
    assert [e["step"] for e in faults] == [7, 9]
    assert [e["step"] for e in r2.events if e["kind"] == "restore"] == [5, 5]
    assert int(s1["step"]) == int(s2["step"]) == 12
    # history: 0-6, replay 5-8, replay 5-11; every replayed step is the first pass's
    losses2 = [h["loss"] for h in h2]
    assert losses2[:7] == [h["loss"] for h in h1[:7]]
    assert losses2[7:11] == [h["loss"] for h in h1[5:9]]
    assert losses2[11:] == [h["loss"] for h in h1[5:]]
    _bitwise(s1, s2)


def test_resume_continues_bit_for_bit_and_rescale_restores(tmp_path, one_torch_thread):  # noqa: F811
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.runner import TrainRunner

    s_ref, h_ref = _runner(tmp_path, "ref").run(_batches(), 8)
    r1 = _runner(tmp_path, "split")
    r1.run(_batches(), 5)
    r2 = _runner(tmp_path, "split")  # a new process would do the same
    s2, h2 = r2.run(_batches(), 8)
    assert r2.events[0] == {"kind": "restore", "step": 5}
    assert [h["loss"] for h in h2] == [h["loss"] for h in h_ref[5:]]
    _bitwise(s_ref, s2)
    r3 = TrainRunner.rescale(get_smoke_config("olmo_1b"), "1x1", adamw(1e-3), r2.run_cfg,
                             device="cpu")
    s3 = r3.restore_or_init()
    assert int(s3["step"]) == 8 and r3.events == [{"kind": "restore", "step": 8}]
    _bitwise(s_ref, s3)


def test_straggler_detection(tmp_path, one_torch_thread):  # noqa: F811
    def slow(step):
        if step == 9:  # a straggling host: twice the threshold over the slowest step yet
            time.sleep(2 * r.run_cfg.deadline_factor * max(r.step_times))

    r = _runner(tmp_path, "slow", slow, ckpt_every=50, deadline_factor=3.0)
    r.run(_batches(), 11)
    assert any(e["step"] == 9 for e in r.events if e["kind"] == "straggler"), r.events


def test_max_restarts_and_refusals(tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    def always(step):
        raise RuntimeError("dead node")

    r = _runner(tmp_path, "dead", always, max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded max_restarts=2"):
        r.run(_batches(), 3)
    assert len([e for e in r.events if e["kind"] == "fault"]) == 3
    rc = RunnerConfig(str(tmp_path / "x"))
    cfg = get_smoke_config("olmo_1b")
    for mesh in ("2x4", (1, 8)):  # a family the sharded path does not run
        with pytest.raises(NotImplementedError, match="sharded-training"):
            TrainRunner(get_smoke_config("xlstm_1p3b"), mesh, adamw(1e-3), rc, device="cpu")
    with pytest.raises(ValueError, match="Mesh"):  # a dense run: on the ranks of a Mesh
        TrainRunner(cfg, "2x4", adamw(1e-3), rc, device="cpu")
    xl = TrainRunner(get_smoke_config("xlstm_1p3b"), None, adamw(1e-3), rc, device="cpu")
    assert xl.init_state()["params"]["slstm"]["mixer"]["r_i"].shape[0] == 2
    with pytest.raises(ValueError, match="slstm_every"):
        TrainRunner(dataclasses.replace(get_smoke_config("xlstm_1p3b"), n_layers=3), None,
                    adamw(1e-3), rc, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainRunner(cfg, None, adamw(1e-3), rc)


# -- the CLI ------------------------------------------------------------------------


def test_cli_trains_recovers_and_rescales_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
                      "--ckpt-every", "5", "--inject-fault-at", "7", "--rescale-mesh", "1x1",
                      "--ckpt-dir", str(tmp_path / "ck")])
    text = capsys.readouterr().out
    assert "(1 faults recovered)" in text
    assert f"checkpoints in {tmp_path / 'ck'}: steps [5, 10, 12]" in text
    assert "elastic rescale 1x1 -> 1x1: resumed at step 12" in text
    assert "step    10  loss" in text
    steps_run = [s for s, _ in out["losses"]]
    assert steps_run == list(range(7)) + list(range(5, 12))
    losses = dict(out["losses"][:7])
    assert out["losses"][7][1] == losses[5]  # the first replayed step, exactly
    assert out["faults"] == 1 and out["rescaled_step"] == 12


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"])
def test_cli_trains_moe_with_a_fault_and_replay_on_cpu(arch, tmp_path, capsys):
    """The MoE smoke configs through the CLI: a fault at 5 restored from 4,
    the first replayed loss exactly the first pass's, every step's moe_aux
    in the loss (loss = ce + 0.01 moe_aux), the rescale reload."""
    from repro_torch.launch import train

    out = train.run(train.parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "16",
        "--ckpt-every", "4", "--inject-fault-at", "5", "--rescale-mesh", "1x1",
        "--ckpt-dir", str(tmp_path / "ck")]))
    assert "(1 faults recovered)" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == list(range(5)) + list(range(4, 8))
    assert out["losses"][5][1] == dict(out["losses"][:5])[4]  # the first replayed step
    for m in out["history"]:
        assert float(m["moe_aux"]) > 0
        assert abs(float(m["loss"]) - float(m["ce"]) - 0.01 * float(m["moe_aux"])) <= 1e-5
    assert out["ckpt_steps"] == [4, 8] and out["rescaled_step"] == 8


def test_cli_trains_xlstm_with_a_fault_and_replay_on_cpu(tmp_path, capsys):
    """xlstm's smoke config (2 groups of an mLSTM and an sLSTM block)
    through the CLI: a fault at 6 restored from 4, both replayed losses
    exactly the first pass's, checkpoints at 4 and 8, the rescale reload."""
    from repro_torch.launch import train

    out = train.run(train.parse_args([
        "--arch", "xlstm_1p3b", "--device", "cpu", "--steps", "8", "--batch", "2", "--seq",
        "16", "--ckpt-every", "4", "--inject-fault-at", "6", "--rescale-mesh", "1x1",
        "--ckpt-dir", str(tmp_path / "ck")]))
    assert "(1 faults recovered)" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == list(range(6)) + list(range(4, 8))
    first = dict(out["losses"][:6])
    assert [x for _, x in out["losses"][6:8]] == [first[4], first[5]]  # replayed exactly
    assert out["ckpt_steps"] == [4, 8] and out["rescaled_step"] == 8
    for m in out["history"]:
        assert np.isfinite(float(m["loss"])) and float(m["moe_aux"]) == 0.0


@pytest.mark.parametrize("argv, match", [
    (["--arch", "xlstm_1p3b", "--n-layers", "3"], "--n-layers"),  # slstm_every is 2
    (["--arch", "zamba2_1p2b", "--n-layers", "1"], "--n-layers"),  # below attn_every
    (["--arch", "hubert_xlarge", "--n-layers", "3"], "--n-layers"),  # its smoke config has 2
    (["--arch", "xlstm_1p3b", "--mesh", "2x4"], "sharded-training"),  # 2 heads over 4
    (["--arch", "hubert_xlarge", "--rescale-mesh", "4x2"], "sharded-training"),
    (["--n-layers", "3"], "--n-layers"),  # the olmo smoke config has 2
])
def test_cli_refusals(argv, match):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--steps", "1"])


def test_cli_defaults_to_the_card():
    from repro_torch.launch import train

    args = train.parse_args([])
    assert args.device == "cuda" and args.arch == "olmo_1b" and args.mesh == "1x1"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--steps", "1"])
