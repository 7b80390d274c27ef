"""Port parity: core/dictionary (the Eq. 51 step, the column projections,
the block layout) against the JAX module, and init_dictionary's contract."""

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, rand, to_jax, to_torch

TOL = 1e-6


@pytest.mark.parametrize("nonneg", [False, True])
def test_dict_update_and_projections_match_jax(nonneg):
    from repro.core import dictionary as jd
    from repro_torch.core import dictionary as td

    rng = np.random.default_rng(int(nonneg))
    W, nu, y = 0.6 * rand(rng, 12, 7), rand(rng, 5, 12), rand(rng, 5, 7)
    W[:, 0] *= 4.0  # one column outside the unit ball
    assert_close(td.make_projection(nonneg)(to_torch(W)),
                 jd.make_projection(nonneg)(to_jax(W)), rtol=TOL, atol=TOL)
    assert_close(td.dict_update(to_torch(W), to_torch(nu), to_torch(y), 0.3, nonneg=nonneg),
                 jd.dict_update(to_jax(W), to_jax(nu), to_jax(y), 0.3, nonneg=nonneg),
                 rtol=TOL, atol=TOL)
    # agent-batched: each block steps with its own (nu_k, y_k)
    Wb, nub, yb = rand(rng, 3, 12, 7), rand(rng, 3, 5, 12), rand(rng, 3, 5, 7)
    got = td.dict_update(to_torch(Wb), to_torch(nub), to_torch(yb), 0.3, nonneg=nonneg)
    for a in range(3):
        assert_close(got[a], jd.dict_update(to_jax(Wb[a]), to_jax(nub[a]), to_jax(yb[a]), 0.3,
                                            nonneg=nonneg), rtol=TOL, atol=TOL)


def test_blocks_layout_matches_jax_and_init_is_unit_norm():
    from repro.core import dictionary as jd
    from repro_torch.core import dictionary as td

    W = rand(np.random.default_rng(5), 6, 12)
    blocks = td.blocks_from_full(to_torch(W), 4)
    assert blocks.is_contiguous()
    assert_close(blocks, jd.blocks_from_full(to_jax(W), 4), rtol=0, atol=0)
    assert torch.equal(td.full_from_blocks(blocks), to_torch(W))
    with pytest.raises(ValueError):
        td.blocks_from_full(to_torch(W), 5)
    for nonneg in (False, True):
        gen = torch.Generator().manual_seed(0)
        W0 = td.init_dictionary(gen, 9, 14, nonneg=nonneg, device="cpu")
        assert W0.shape == (9, 14) and W0.dtype == torch.float32
        assert_close(torch.linalg.vector_norm(W0, dim=0), np.ones(14, np.float32), rtol=TOL, atol=TOL)
        if nonneg:
            assert bool((W0 >= 0).all())
