"""Port parity, bit for bit: the topology copies and the int8 wire format.

The port's numpy copies in repro_torch/core/topology.py make the same RNG
calls as src/repro/core/topology.py, so every combiner, sequence and chain
must equal the JAX package's exactly; `quantize_q8` must give the JAX
payload and scales to the bit (round half to even on both sides).  Also
the port's schedules against the JAX ones: the same A, the same message
counts (the torus's 4-link rounds included).
"""

import numpy as np
import pytest
import torch

from test_torch_common import rand, to_jax


def _same_schedule(ts, js):
    """A port TopologySchedule against a JAX one, field by field."""
    assert type(ts).__name__ == type(js).__name__
    assert (ts.spec, ts.n, ts.kinds, ts.period) == (js.spec, js.n, js.kinds, js.period)
    assert (ts.p, ts.seed, ts.beta) == (js.p, js.seed, js.beta)
    for a, b in zip(ts.combiners, js.combiners, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.adjacencies, js.adjacencies, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.window_combiner(), js.window_combiner())
    assert ts.windowed_mixing_rate() == js.windowed_mixing_rate()
    np.testing.assert_array_equal(ts.stacked(), js.stacked())
    A_t, A_j = ts.as_callable(), js.as_callable()
    for t in range(2 * ts.period + 1):
        np.testing.assert_array_equal(A_t(t).numpy(), np.asarray(A_j(t)))


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("kind", ["dicycle", "distar"])
def test_directed_kinds_match_jax(kind, n):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    A = tt.make_topology(kind, n)
    np.testing.assert_array_equal(A, jt.make_topology(kind, n))
    assert tt.is_row_stochastic(A) and tt.is_strongly_connected(A > 0)
    assert tt.is_doubly_stochastic(A) == jt.is_doubly_stochastic(A) == (kind == "dicycle")
    assert tt.DIRECTED_KINDS == jt.DIRECTED_KINDS
    adj = np.zeros((n, n), bool)
    adj[0, 1:] = True  # 0 reaches everyone, nobody reaches 0
    assert not tt.is_strongly_connected(adj) and not jt.is_strongly_connected(adj)


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("spec,period", [("fixed:erdos", 2),
                                         ("alternating:ring_metropolis,torus", 2),
                                         ("erdos_resampled", 3),
                                         ("alternating:erdos,ring,full", 2)])
def test_topology_schedules_match_jax(spec, period, n):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    kw = dict(p=0.5, seed=7, beta=0.25, period=period)
    _same_schedule(tt.make_topology_schedule(spec, n, **kw),
                   jt.make_topology_schedule(spec, n, **kw))
    assert tt.derive_seed(7, 3, n) == jt.derive_seed(7, 3, n)


@pytest.mark.parametrize("base", ["alternating:ring_metropolis,torus", "chain"])
def test_link_failure_schedule_matches_jax(base):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    if base == "chain":
        specs = "ring_metropolis,torus:2"
        bt = tt.make_kronecker_chain(tt.parse_level_specs(specs), (4, 4), seed=3)
        bj = jt.make_kronecker_chain(jt.parse_level_specs(specs), (4, 4), seed=3)
    else:
        bt = tt.make_topology_schedule(base, 16, seed=3)
        bj = jt.make_topology_schedule(base, 16, seed=3)
    ft = tt.link_failure_schedule(bt, 0.25, failure_seed=5, steps=6)
    fj = jt.link_failure_schedule(bj, 0.25, failure_seed=5, steps=6)
    _same_schedule(ft, fj)
    assert (ft.fail_p, ft.failure_seed) == (fj.fail_p, fj.failure_seed)
    _same_schedule(ft.base, fj.base)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            tt.link_failure_schedule(bt, bad)


@pytest.mark.parametrize("specs,ns", [
    ("ring_metropolis,ring_metropolis:2", (4, 2)),
    ("torus,ring_metropolis:2:q8,ring:4:q8:stale", (4, 2, 2)),
    ("erdos,full:3,erdos:2:stale", (5, 3, 2)),
])
def test_kronecker_chain_matches_jax(specs, ns):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    ct = tt.make_kronecker_chain(tt.parse_level_specs(specs), ns, p=0.5, seed=9, beta=0.25)
    cj = jt.make_kronecker_chain(jt.parse_level_specs(specs), ns, p=0.5, seed=9, beta=0.25)
    assert (ct.ns, ct.period, ct.n_agents, ct.n_levels) == (cj.ns, cj.period, cj.n_agents,
                                                            cj.n_levels)
    assert [vars(s) for s in ct.specs] == [vars(s) for s in cj.specs]
    for a, b in zip(ct.combiners + ct.adjacencies, cj.combiners + cj.adjacencies, strict=True):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ct.sequence(), cj.sequence(), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ct.kron(), cj.kron())
    np.testing.assert_array_equal(ct.window_combiner(), cj.window_combiner())
    assert ct.mixing_rate() == cj.mixing_rate()
    assert ct.effective_mixing_rate() == cj.effective_mixing_rate()
    A_t, A_j = ct.as_callable(), cj.as_callable()
    for t in range(ct.period + 2):
        np.testing.assert_array_equal(A_t(t).numpy(), np.asarray(A_j(t)))


@pytest.mark.parametrize("pod_kind,model_kind,every", [("ring_metropolis", "torus", 2),
                                                        ("erdos", "erdos", 1)])
def test_hierarchical_topology_matches_jax(pod_kind, model_kind, every):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    ht = tt.make_hierarchical_topology(pod_kind, model_kind, 3, 4, seed=2, gossip_every=every)
    hj = jt.make_hierarchical_topology(pod_kind, model_kind, 3, 4, seed=2, gossip_every=every)
    np.testing.assert_array_equal(ht.A_pod, hj.A_pod)
    np.testing.assert_array_equal(ht.A_model, hj.A_model)
    assert (ht.period, ht.n_agents) == (hj.period, hj.n_agents)
    for a, b in zip(ht.sequence(), hj.sequence(), strict=True):
        np.testing.assert_array_equal(a, b)
    for f in ("kron", "local_only", "window_combiner"):
        np.testing.assert_array_equal(getattr(ht, f)(), getattr(hj, f)())
    assert ht.mixing_rate() == hj.mixing_rate()
    assert ht.effective_mixing_rate() == hj.effective_mixing_rate()
    assert tt.kron_mixing_rate(ht.A_pod, ht.A_model) == jt.kron_mixing_rate(hj.A_pod, hj.A_model)
    np.testing.assert_array_equal(ht.as_callable()(1).numpy(), np.asarray(hj.as_callable()(1)))


@pytest.mark.parametrize("spec", [
    "torus,ring_metropolis:2:q8,ring:4:q8:stale",
    "ring", "full:stale:3", " erdos : q8 , ring:2 ",
    "ring:q9", "ring,,torus", "ring:0", "ring:-2", "ring:fp16",
])
def test_parse_level_specs_matches_jax(spec):
    from repro.core import topology as jt
    from repro_torch.core import topology as tt

    try:
        want = [vars(s) for s in jt.parse_level_specs(spec)]
    except ValueError:
        with pytest.raises(ValueError):
            tt.parse_level_specs(spec)
        return
    assert [vars(s) for s in tt.parse_level_specs(spec)] == want


def test_quantize_q8_matches_jax_bit_for_bit():
    from repro.runtime import dist
    from repro_torch.runtime import comm

    rng = np.random.default_rng(3)
    rows = [rand(rng, 6, 33) * 3.0,
            # exact .5 ties: the scale is 1 (127 / 127 + 1e-30 rounds to 1)
            np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]], np.float32),
            np.zeros((2, 9), np.float32)]
    for x in rows:
        qj, sj = dist.quantize_q8(to_jax(x))
        qt, st = comm.quantize_q8(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(comm.dequantize_q8(qt, st).numpy(),
                                      np.asarray(dist.dequantize_q8(qj, sj)))
    q, _ = comm.quantize_q8(torch.from_numpy(rows[1]))
    assert q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -4]  # half to even


@pytest.mark.parametrize("kind", ["ring_metropolis", "torus", "erdos", "full", "distar"])
@pytest.mark.parametrize("n", [4, 6, 16])
def test_schedules_realize_the_combiner_with_jax_message_counts(kind, n):
    from repro.core.topology import torus_dims
    from repro.runtime import dist
    from repro_torch.core.topology import make_topology
    from repro_torch.runtime import comm

    A = make_topology(kind, n, seed=3)
    if kind == "distar":
        with pytest.raises(ValueError):
            comm.graph_schedule(A)
        ts, js = (comm.graph_schedule(A, row_stochastic=True),
                  dist.graph_schedule(A, row_stochastic=True))
    elif kind == "torus":
        ts, js = comm.torus_schedule(*torus_dims(n), A), dist.torus_schedule(*torus_dims(n), A)
    else:
        ts, js = comm.graph_schedule(A), dist.graph_schedule(A)
    np.testing.assert_allclose(ts.reconstruct(), A, atol=1e-12)
    np.testing.assert_allclose(js.reconstruct(), A, atol=1e-12)
    assert ts.messages_per_iter == js.messages_per_iter
    if kind != "distar":  # a time-varying sequence is doubly stochastic
        (seq,) = comm.graph_schedule_sequence([A], [kind])
        (seq_j,) = dist.graph_schedule_sequence([A], [kind])
        assert seq.messages_per_iter == seq_j.messages_per_iter
        np.testing.assert_allclose(seq.reconstruct(), A, atol=1e-12)


def test_chain_schedule_counts_match_jax():
    from repro.core import topology as jt
    from repro.runtime import dist
    from repro_torch.core import topology as tt
    from repro_torch.runtime import comm

    specs, ns, axes = "torus,ring_metropolis:2:q8,ring:4:q8:stale", (4, 3, 2), ("a", "b", "c")
    cs_t = comm.chain_schedule(tt.make_kronecker_chain(tt.parse_level_specs(specs), ns), axes)
    cs_j = dist.chain_schedule(jt.make_kronecker_chain(jt.parse_level_specs(specs), ns), axes)
    assert cs_t.period == cs_j.period and cs_t.ns == ns
    assert cs_t.messages_per_iter_per_level == cs_j.messages_per_iter_per_level
    assert comm.wire_bytes_per_level(cs_t, 16, 8192) == dist.wire_bytes_per_level(cs_j, 16, 8192)
    np.testing.assert_allclose(cs_t.reconstruct(), cs_j.reconstruct(), atol=1e-12)
    assert [(p.axis, p.gossip_every, p.quantized, p.stale) for p in cs_t.levels] == \
        [(p.axis, p.gossip_every, p.quantized, p.stale) for p in cs_j.levels]
