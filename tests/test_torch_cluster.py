"""The torch port's offset-GP clustering (``utils/cluster.py``) against the JAX
package's, in float64 on the CPU, on tests/test_cluster.py's data (two
shifted copies each of two curves): the same groups, and the same pair log
likelihoods (rtol 1e-9) and offsets (1e-8) from the same L-BFGS on the same
padded lanes. The card's test of one clustering round through the K kernel
and its backward against the plain K is in tests/test_torch_cuda_kernels.py."""
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.utils import cluster as jc
from gaussian_process_optimization_tpu_torch.utils import cluster as tc
from test_cluster import _two_groups
from torch_threads import one_torch_thread  # noqa: F401

CASES = {"same_shape": ([0, 1], True), "cross_shape": ([0, 2], True),
         "no_offset": ([0, 1], False)}


@pytest.fixture(scope="module")
def jax_pairs():
    """The JAX package's pair fits, computed once."""
    data, inputs = _two_groups()
    out = {}
    for name, (clust, offset) in CASES.items():
        fit = jc.get_log_likelihood_offset if offset else jc.get_log_likelihood
        out[name] = fit(inputs, data, clust, maxiter=60)
    return out


def _port_groups():
    data, inputs = _two_groups()
    return tc.cluster([d.copy() for d in data], [x.copy() for x in inputs], maxiter=60,
                      device="cpu")


def test_cluster_recovers_the_groups():
    """The JAX package's groups on this data, in its order (each join keeps
    the lower index first, as its loop does): [[1, 0], [3, 2]]."""
    assert _port_groups() == [[1, 0], [3, 2]]


@pytest.mark.slow
def test_cluster_groups_match_jax():
    """Against a live run of the JAX package's loop. Marked slow: it compiles
    its lane fit once per round's lane count (~15 s)."""
    data, inputs = _two_groups()
    assert _port_groups() == jc.cluster([d.copy() for d in data], [x.copy() for x in inputs],
                                        maxiter=60)


@pytest.mark.parametrize("name", list(CASES))
def test_pair_likelihood_and_offset_match_jax(jax_pairs, name):
    data, inputs = _two_groups()
    clust, offset = CASES[name]
    fit = tc.get_log_likelihood_offset if offset else tc.get_log_likelihood
    ll, off = fit(inputs, data, clust, maxiter=60, device="cpu")
    jll, joff = jax_pairs[name]
    np.testing.assert_allclose(ll, jll, rtol=1e-9)
    np.testing.assert_allclose(off, joff, rtol=0, atol=1e-8)
    if name == "same_shape":
        assert abs(abs(off) - 0.4) < 0.05  # the generating shift


def test_merge_alignment_sign():
    """The greedy merge applies the fitted offset with the pair fit's sign
    (added to cluster j's rows): the merged cluster's offset-free LL equals
    the pair's, and the wrong sign is far worse."""
    data, inputs = _two_groups()
    ll_pair, off = tc.get_log_likelihood_offset(inputs, data, [0, 1], maxiter=60, device="cpu")
    merged_y = [np.hstack([data[0], data[1]])]
    ll_merged, _ = tc.get_log_likelihood([np.vstack([inputs[0], inputs[1] + off])], merged_y,
                                         [0], maxiter=60, device="cpu")
    ll_wrong, _ = tc.get_log_likelihood([np.vstack([inputs[0], inputs[1] - off])], merged_y,
                                        [0], maxiter=60, device="cpu")
    assert abs(ll_merged - ll_pair) < 1.0
    assert ll_wrong < ll_pair - 20
