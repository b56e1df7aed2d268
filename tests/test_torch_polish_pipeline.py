"""The slice as a whole with the gradient polish: mvskit_tpu_torch's
PMMVS with refine_grad_steps=2 against mvskit_tpu's on the small config
of tests/test_torch_pipeline.py (seed + two iterations), the port fed the
JAX driver's random numbers. Tolerances as that test's: alive count per
iteration within 3 %, acc_mean and comp_frac within 10 % relative of
JAX's (a near-tie accept/reject, and a polish step's direction, round
otherwise in float32 sums of another order). A file of its own: its
pair takes most of the polish tests' time, and the test runner deals
whole files to its workers."""

import pytest

from mvskit_tpu.utils import synthetic as jsyn
from test_torch_pipeline import assert_alive_tracks_jax, assert_quality_tracks_jax, run_pair


@pytest.fixture(scope="module")
def polished_runs(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("scene"))
    jsyn.write_dataset(prefix, n_views=6, width=160, height=120, n_seeds=48)
    return run_pair(prefix, refine_grad_steps=2)


def test_pipeline_with_polish_tracks_jax(polished_runs):
    assert_alive_tracks_jax(polished_runs)
    assert assert_quality_tracks_jax(polished_runs)["acc_median"] < 0.02
    assert polished_runs["torch"]["engine"].prop_params.grad_steps == 2
