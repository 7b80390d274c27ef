"""The experiment twins (repro_torch/experiments) end to end on the CPU at
tiny cuts: each runs through its command line, returns the JAX script's
result layout, and writes its JSON under build/experiments/ (never the JAX
package's experiments/bench/)."""

import contextlib
import functools
import json
from unittest import mock

import numpy as np
import pytest

from test_torch_common import one_torch_thread

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TWINS = {
    "fig4_convergence": ["--iters", "600", "--record-every", "200", "--m", "16",
                         "--n-agents", "4"],
    "fig5_denoise": ["--patch", "3", "--n-patches", "64", "--img-size", "12"],
    "table3_auc": ["--n-steps", "1", "--m-vocab", "40", "--atoms-per-step", "2"],
    "table4_auc_huber": [],
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_runs_on_cpu_and_writes_under_build(name):
    import importlib

    from repro_torch.experiments import common, table3_auc

    mod = importlib.import_module(f"repro_torch.experiments.{name}")
    out = common.OUT / f"{name}.json"
    out.unlink(missing_ok=True)
    assert out.parent == common.ROOT / "build" / "experiments"
    # table4 runs table3's protocol twice at table3's defaults: cut it here
    small = functools.partial(table3_auc.run, n_steps=1, m_vocab=40, atoms_per_step=2)
    with mock.patch.object(mod, "run_l2", small) if name == "table4_auc_huber" else \
            contextlib.nullcontext():
        result = common.main(mod.run, TWINS[name] + ["--device", "cpu"])
    assert json.loads(out.read_text()) is not None
    if name == "fig4_convergence":
        assert set(result) == {"nmf", "nmf_huber"} and len(result["nmf"]) == 3
        assert all(np.isfinite(r["snr_nu_db"]) for rows in result.values() for r in rows)
    elif name == "fig5_denoise":
        assert set(result) == {"noisy_psnr_db", "untrained_psnr_db", "dist_all_informed_psnr_db",
                               "dist_one_informed_psnr_db", "centralized_mairal_psnr_db"}
        assert all(np.isfinite(v) for v in result.values())
    elif name == "table3_auc":
        assert set(result) == {"diffusion_fc", "diffusion_dist", "centralized"}
        assert all(0.0 <= a <= 1.0 for aucs in result.values() for a in aucs.values())
    else:
        assert set(result) == {"diffusion_fc", "diffusion_dist"}
        assert all(0.0 <= v <= 1.0 for s in result.values() for v in s.values())


def test_streaming_quickstart_runs_on_cpu_at_the_jax_sizes():
    """The twin of examples/streaming_quickstart.py through its command line
    on the CPU: 256 samples of M 32 on 2 agents of 8 atoms, grown to 4 at
    sample 128; every sample coded, y dims 16 then 32."""
    from repro_torch.experiments import common, streaming_quickstart

    result = common.main(streaming_quickstart.run, ["--device", "cpu"])
    assert result["coded"] == 256 and result["fit_steps"] >= 1
    assert result["y_dims"] == [16, 32]
    g = result["growth"]
    assert (g["model_old"], g["model_new"], g["k_old"], g["k_new"]) == (2, 4, 16, 32)
    assert np.isfinite(result["residual_last32"])
    assert json.loads((common.OUT / "streaming_quickstart.json").read_text())["coded"] == 256
