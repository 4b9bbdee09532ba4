"""The JAX package's own float32 error at the card's fitted leaves of
``chip_smoke.py`` phase 11 (tests/data/latent_card_fitted.npz, the file the
phase writes as chiprun_out/latent_fitted.npz, from the run PERF.md names),
against float64, on the CPU: the readings behind phase 11's limits
(``LATENT_JAX_F32``, ``LATENT_LEG3_JAX_F32``). Each JAX model is its own
``create`` on the same data with the card's leaves put in; leg 1 also reads
the gradient with the X block, against the port's float64 terms. ``-s``
prints every reading. Marked slow: the point GPLVM's float64 gradient at N =
4096 and the IBP model's EQ_ODE2 take minutes in the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import bgplvm_svi as jsvi
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import gplvm as jg
from gaussian_process_optimization_tpu.models import ibp_lfm as jibp
from gaussian_process_optimization_tpu.models import lvmogp as jlv
from gaussian_process_optimization_tpu.models import mrd as jmrd
from gaussian_process_optimization_tpu.models import ss_gplvm as jss
from gaussian_process_optimization_tpu.models import zoo as jzoo
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.sparse import SparseGPRegression as JSparse
from gaussian_process_optimization_tpu_torch import workload
from test_torch_gplvm import jgplvm_packer, port_gp, saved_leaves, with_leaves
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow
_saved = saved_leaves


def _f32(m):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32) if jnp.issubdtype(jnp.asarray(a).dtype,
                                                                 jnp.floating) else a, m)


class _Sum:
    def __init__(self, models):
        self.models = models

    def log_marginal_likelihood(self):
        return sum(m.log_marginal_likelihood() for m in self.models)


def _leg3_templates():
    d = workload.latent_leg_data(512, 0)
    Y, Xc, yc, cls = d["Y"], d["Xc"], d["yc"], d["cls"]
    one_vs_all = jzoo.OneVsAllClassification(Xc[:256], cls[:256])
    sparse_ova = jzoo.OneVsAllSparseClassification(Xc, cls, num_inducing=32)
    Yc = Y - Y.mean(0)
    return {
        "MRD": jmrd.MRD.create(d["views"], 4, num_inducing=8),
        "SSGPLVM": jss.SSGPLVM.create(Y, 3, num_inducing=8),
        "LVMOGP": jlv.LVMOGP.create(d["x1"], d["lv_Y"], 2, num_inducing=(10, 5)),
        "BGPLVM_SVI": jsvi.BGPLVM_SVI.create(d["views"][0], 3, num_inducing=8),
        "IBPLFM": jibp.IBPLFM.create(d["ibp_X"], d["ibp_Y"], output_dim=3, rank=2,
                                     num_inducing=10),
        "GPHeteroscedasticRegression": jzoo.GPHeteroscedasticRegression(
            Xc, yc[:, None], noise_vars=np.full(512, 0.05)),
        "GPKroneckerGaussianRegression": jzoo.GPKroneckerGaussianRegression(
            d["g1"], d["g2"], d["grid_Y"], jk.RBF.create(1), jk.RBF.create(1), noise_var=0.1),
        "GPVariationalGaussianApproximation": jzoo.GPVariationalGaussianApproximation.create(
            Xc[:256], yc[:256]),
        "OneVsAllClassification": [one_vs_all.models[c] for c in one_vs_all.classes_],
        "OneVsAllSparseClassification": [sparse_ova.models[c] for c in sparse_ova.classes_],
        "bcgplvm": JGP.create(np.zeros((512, 2)), Yc, kernel=jk.RBF.create(2, ARD=True),
                              noise_var=0.1),
        "sparse_gplvm": JSparse.create(np.zeros((512, 2)), Yc,
                                       kernel=jk.RBF.create(2, ARD=True), num_inducing=16),
        "GPOffsetRegression": jzoo.GPOffsetRegression.create(d["off_X"], d["off_Y"]),
    }


def _neg_bound(m):
    if hasattr(m, "log_marginal_likelihood"):
        return -float(m.log_marginal_likelihood())
    return -float(m.elbo())


LEG3 = ["MRD", "SSGPLVM", "LVMOGP", "BGPLVM_SVI", "IBPLFM", "GPHeteroscedasticRegression",
        "GPKroneckerGaussianRegression", "GPVariationalGaussianApproximation",
        "OneVsAllClassification", "OneVsAllSparseClassification", "bcgplvm", "sparse_gplvm",
        "GPOffsetRegression"]


@pytest.mark.parametrize("name", LEG3)
def test_f32_bound_error_of_leg3_at_the_cards_fitted_point(name):
    template = _leg3_templates()[name]
    saved = _saved(name)
    if isinstance(template, list):
        m = _Sum([with_leaves(t, {k[len(f"models.{i}."):]: v for k, v in saved.items()
                                  if k.startswith(f"models.{i}.")})
                  for i, t in enumerate(template)])
        f64 = _neg_bound(m)
        with jax.enable_x64(False):
            f32 = _neg_bound(_Sum([_f32(x) for x in m.models]))
    else:
        m = with_leaves(template, saved)
        f64 = _neg_bound(m)
        with jax.enable_x64(False):
            f32 = _neg_bound(_f32(m))
    rel = abs(f32 - f64) / abs(f64)
    print(f"{name}: the JAX package's float32 at the card's fitted point: -bound {f32:.6f} vs "
          f"{f64:.6f} (rel {rel:.3e})")
    assert np.isfinite(f32) and np.isfinite(f64)


def test_f32_error_of_legs_1_and_2_at_the_cards_fitted_point():
    """Leg 1: -LML and the gradient with the X block (chip_smoke's measure,
    ``gplvm_gradient_error``); leg 2: the -ELBO. The port's float64 -LML
    equals the JAX package's at the same leaves."""
    import chip_smoke

    Y, _, _ = workload.latent_data()
    jm = with_leaves(jg.make_gplvm(Y, 6, kernel=jk.RBF.create(6, ARD=True) + jk.Bias.create(6)),
                     _saved("gplvm"))
    packer = jgplvm_packer(jm)

    def value_and_grad(m, pk):
        f, g = jax.value_and_grad(lambda u: jfit.make_objective(pk)(u, m))(pk.pack(m))
        return float(f), np.asarray(g, dtype=float)

    f64, g64 = value_and_grad(jm, packer)
    with jax.enable_x64(False):
        m32 = _f32(jm)
        f32, g32 = value_and_grad(m32, jgplvm_packer(m32))
    tm = port_gp(jm)
    ld, q = chip_smoke._gplvm_terms(tm)
    with torch.no_grad():
        np.testing.assert_allclose(-float(tm.log_marginal_likelihood()), f64, rtol=1e-9)
    np.testing.assert_allclose((ld + q).numpy(), g64, rtol=1e-6, atol=1e-6 * np.abs(g64).max())
    n_hyper = packer.num_free - jm.X.size
    g_all, g_hyp, g_x = chip_smoke.gplvm_gradient_error(
        torch.as_tensor(g32), torch.zeros(1, dtype=torch.float64), ld, q, n_hyper)
    rel = abs(f32 - f64) / abs(f64)
    print(f"gplvm: the JAX package's float32 at the card's fitted point: -LML {f32:.6f} vs "
          f"{f64:.6f} (rel {rel:.3e}); gradient {g_all:.3e} of its terms (hyperparameters "
          f"{g_hyp:.3e}, X block {g_x:.3e})")
    start = jg.BayesianGPLVM.create(Y, 7, num_inducing=40, kernel=jk.RBF.create(7, ARD=True))
    for where, jb in (("start", start), ("card's fitted point", with_leaves(start,
                                                                         _saved("bgplvm")))):
        b64 = -float(jb.elbo())
        with jax.enable_x64(False):
            b32 = -float(_f32(jb).elbo())
        print(f"bgplvm: the JAX package's float32 at the {where}: -ELBO {b32:.6f} vs "
              f"{b64:.6f} (rel {abs(b32 - b64) / abs(b64):.3e})")
    assert all(np.isfinite(v) for v in (f32, g_all, b32))
