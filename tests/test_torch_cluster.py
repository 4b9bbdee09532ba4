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


def test_history_records_each_round_and_lane_lml_reproduces_it():
    """``cluster(history=...)`` keeps every round's fitted lanes: ``lane_lml``
    at a lane's leaves gives its log likelihood again (rtol 1e-10); the joins
    read back from them (``prof_stages.cluster_joins``) are the loop's, each
    improvement the pair's log likelihood less its singles', the last the
    stop; and lanes fitted a few at a time (``max_lanes``) give the same
    groups."""
    from gaussian_process_optimization_tpu_torch.prof_stages import cluster_joins

    data, inputs = _two_groups()
    history = []
    groups = tc.cluster([d.copy() for d in data], [x.copy() for x in inputs], maxiter=60,
                        device="cpu", history=history)
    assert groups == [[1, 0], [3, 2]]
    assert len(history[0]) == 10  # 4 singles and 6 pairs
    for fits in history:
        ll = tc.lane_lml(np.stack([f[2] for f in fits]), [f[1] for f in fits], device="cpu")
        np.testing.assert_allclose(ll, [f[3] for f in fits], rtol=1e-10)
    joins = cluster_joins(history)
    assert [j[1] for j in joins] == [True, True, False]
    assert [sorted(sum(j[2][0], ())) for j in joins[:2]] == [[0, 1], [2, 3]]
    for imp, _, pair, (si, sj) in joins:
        assert imp == pytest.approx(pair[3] - si[3] - sj[3], rel=1e-12)
    assert tc.cluster([d.copy() for d in data], [x.copy() for x in inputs], maxiter=60,
                      device="cpu", max_lanes=3) == groups


@pytest.mark.slow
def test_jax_f32_first_round_reading_at_the_cards_leaves():
    """The JAX package's own float32 log likelihood of each of the first
    round's 820 lanes (``chip_smoke.py`` phase 12's 40 series, cut to 30
    L-BFGS steps on an H100) at the leaves the card's float32 fit reached
    (tests/data/cluster_first_round.npz, from chiprun_out/cluster_first_round.npz),
    against its float64 at the same leaves, printed with ``-s``: the reading
    behind ``chip_smoke.CLUSTER_LL_LIMIT``, beside the port's own float32 on
    the CPU.
    Marked slow: 820 lanes in two dtypes in each package."""
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu_torch import workload

    U = np.load(Path(__file__).parent / "data" / "cluster_first_round.npz")["U"]
    data, inputs, _ = workload.cluster_data(40, 20)
    # the first round's lanes in the loop's order: each single, then its pairs
    # with every series before it
    items = []
    for i in range(len(data)):
        items.append((inputs[i], data[i].T, np.zeros(inputs[i].shape[0])))
        items += [(np.vstack([inputs[i], inputs[j]]), np.vstack([data[i].T, data[j].T]),
                   np.concatenate([np.zeros(inputs[i].shape[0]), np.ones(inputs[j].shape[0])]))
                  for j in range(i)]
    assert U.shape == (len(items), 4)
    batch = jc._pad_stack(items, max(x.shape[0] for x, _, _ in items))
    lml = jax.vmap(lambda u, X, Y, s, m: jc._masked_lml(u, X, Y, s, m, True))
    U64 = tc.f32_effective(U)  # float64 at the noise float32 evaluates
    ll64 = np.asarray(jax.jit(lml)(jnp.asarray(U64, jnp.float64), *batch))
    with jax.enable_x64(False):
        ll32 = np.asarray(jax.jit(lml)(jnp.asarray(U, jnp.float32),
                                       *(jnp.asarray(a, jnp.float32) for a in batch)))
    port32 = tc.lane_lml(U, items, dtype=torch.float32, device="cpu")
    port64 = tc.lane_lml(U64, items, dtype=torch.float64, device="cpu")

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    print(f"the first round's lane log likelihoods at the card's leaves, float32 against "
          f"float64 at the same noise, max |diff| / max |LL64| over {len(items)} lanes: the "
          f"JAX package {rel(ll32, ll64):.3e}, the port on the CPU {rel(port32, port64):.3e}")
    np.testing.assert_allclose(port64, ll64, rtol=1e-9)


def test_f32_effective_noise_and_refit():
    """``f32_effective`` moves only a noise under float32's floor, after which
    float64 evaluates the Gram float32 does: the lane LLs (noise 1e-7 and
    1e-2 in turn) agree to float32's rounding at cond ~1e6, not at the raw
    noise; ``prof_stages.refit`` fits lanes as the loop does (its first
    round's lanes again, rtol 1e-4: padded to their own rows, not the loop's,
    the float64 rounding differs and 60 L-BFGS steps carry it to ~3e-5)."""
    from gaussian_process_optimization_tpu_torch.prof_stages import refit

    data, inputs = _two_groups()
    history = []
    tc.cluster([d.copy() for d in data], [x.copy() for x in inputs], maxiter=60,
               device="cpu", history=history)
    first = history[0]
    U = np.stack([f[2] for f in first])
    U[::2, 0] = float(tc._POS.inverse(torch.tensor(1e-7, dtype=torch.float64)))
    U[1::2, 0] = float(tc._POS.inverse(torch.tensor(1e-2, dtype=torch.float64)))
    moved = tc.f32_effective(U)
    np.testing.assert_allclose(moved[1::2], U[1::2], rtol=1e-12)
    noise = tc._POS.forward(torch.as_tensor(moved[:, 0])).numpy() + 1e-6 + 1e-8
    np.testing.assert_allclose(noise[::2], 1e-4, rtol=1e-9)
    items = [f[1] for f in first]
    ll32 = tc.lane_lml(U, items, dtype=torch.float32, device="cpu")
    ll64 = tc.lane_lml(moved, items, dtype=torch.float64, device="cpu")
    raw64 = tc.lane_lml(U, items, dtype=torch.float64, device="cpu")

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    print(f"float32 lane LL against float64 at its noise {rel(ll32, ll64):.3e}, at the raw "
          f"noise {rel(ll32, raw64):.3e}")
    assert rel(ll32, ll64) < 1e-2 < 1e-1 < rel(ll32, raw64)
    ll, _ = refit(items, 60, device="cpu")
    np.testing.assert_allclose(ll, [f[3] for f in first], rtol=1e-4)


@pytest.mark.slow
def test_jax_fits_of_the_cards_family_joins():
    """The lanes of the joins of two families, and of the stop, in the card's
    float32 clustering (``chip_smoke.py`` phase 12's 40 series, 30 L-BFGS
    steps; tests/data/cluster_joins.npz, from ``prof_stages --cluster``),
    fitted again from the loop's start by the JAX package's own
    ``_fit_batch`` in float32 and in float64, and by the port on the CPU, each
    padded to the loop's rows, the three lanes in one batch and in float32
    also each alone: each round's improvement (pair less singles) printed
    with ``-s`` beside the card's float32. The float64 fits agree across the
    packages (rtol 1e-6 in the log likelihoods); a float32 fit of 30 steps
    ends where its batch's rounding takes it."""
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu_torch.prof_stages import refit

    saved = np.load(Path(__file__).parent / "data" / "cluster_joins.npz")
    n_max, maxiter = int(saved["n_max"]), int(saved["maxiter"])
    rounds = sorted({k.split("_")[0] for k in saved.files if k.startswith("r")},
                    key=lambda r: int(r[1:]))
    lines = []
    for r in rounds:
        items = [tuple(saved[f"{r}_{n}{k}"] for n in ("X", "Y", "sel")) for k in range(3)]
        batch = jc._pad_stack(items, n_max)
        U0 = np.broadcast_to(jc._u0(True), (3, 4))
        j64 = np.asarray(jc._fit_batch(jnp.asarray(U0), *batch, True, maxiter)[0])
        with jax.enable_x64(False):
            j32 = np.asarray(jc._fit_batch(jnp.asarray(U0, jnp.float32),
                                           *(jnp.asarray(a, jnp.float32) for a in batch),
                                           True, maxiter)[0])
        p32, _ = refit(items, maxiter, dtype=torch.float32, device="cpu", n_max=n_max)
        p64, _ = refit(items, maxiter, dtype=torch.float64, device="cpu", n_max=n_max)
        np.testing.assert_allclose(p64, j64, rtol=1e-6)
        # each lane fitted alone, a batch of one: float32 only
        with jax.enable_x64(False):
            j32_alone = np.array([float(jc._fit_batch(
                jnp.asarray(U0[:1], jnp.float32),
                *(jnp.asarray(a[k:k + 1], jnp.float32) for a in batch), True, maxiter)[0][0])
                for k in range(3)])
        p32_alone = np.array([refit([it], maxiter, dtype=torch.float32, device="cpu",
                                    n_max=n_max)[0][0] for it in items])

        def imp(ll):
            return float(ll[0] - ll[1] - ll[2])

        lls = "; ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in (
            ("card f32", saved[f"{r}_ll"]), ("JAX f32", j32), ("JAX f32 alone", j32_alone),
            ("JAX f64", j64), ("port f32", p32), ("port f32 alone", p32_alone),
            ("port f64", p64)))
        lines.append(f"{r}: card f32 {imp(saved[f'{r}_ll']):+.4f}; JAX f32 {imp(j32):+.4f}, "
                     f"each lane alone {imp(j32_alone):+.4f}, f64 {imp(j64):+.4f}; port on the "
                     f"CPU f32 {imp(p32):+.4f}, each lane alone {imp(p32_alone):+.4f}, f64 "
                     f"{imp(p64):+.4f} (pair, single, single LLs: {lls})")
    print("the improvements of the card's joins of two families and of its stop, refitted "
          "from the loop's start: " + "; ".join(lines))


@pytest.mark.slow
@pytest.mark.parametrize("package", ["jax", "port"])
def test_f32_clustering_of_the_smokes_series_on_the_cpu(package):
    """``chip_smoke.py`` phase 12's 40 series (``workload.cluster_data``) at
    its 30 L-BFGS steps, clustered in float32 on the CPU by the JAX package
    or by the port, the groups' families printed with ``-s`` (the card's
    float32 joins families 2 and 3, its float64 finds the four). Each round's
    lanes go through the JAX package's ``_fit_batch`` in blocks of 205 (the
    first round's 820 lanes at 800 rows at once take ~10 GB), through the
    port's in blocks of 64; each lane's fit is its own. Marked slow: one to
    two hours a package on three cores."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu_torch import workload

    data, inputs, fam = workload.cluster_data(40, 20)
    data, inputs = [d.copy() for d in data], [x.copy() for x in inputs]
    if package == "jax":
        fit, block = jc._fit_batch, 205

        def blocked(U0, Xb, Yb, selb, maskb, with_offset, maxiter):
            out = [fit(*(a[k:k + block] for a in (U0, Xb, Yb, selb, maskb)), with_offset,
                       maxiter) for k in range(0, U0.shape[0], block)]
            return tuple(jnp.concatenate([o[i] for o in out]) for i in range(2))

        with jax.enable_x64(False):
            jc._fit_batch = blocked
            try:
                groups = jc.cluster(data, inputs, maxiter=30)
            finally:
                jc._fit_batch = fit
    else:
        groups = tc.cluster(data, inputs, maxiter=30, device="cpu", dtype=torch.float32,
                            max_lanes=64)
    print(f"float32 clustering of the smoke's 40 series on the CPU by the {package} package, "
          f"families per group: {[sorted({fam[i] for i in g}) for g in groups]}")
    assert sorted(sum(groups, [])) == list(range(40))
