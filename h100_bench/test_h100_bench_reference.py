"""The float64 reference and the comparison that decides ``correct``.

On the CPU in float64 at a small size the port and the reference compute the
same things, so every compared number reads at rounding and the cell's own
limits pass. With the timed path broken underneath (an answer altered where it
is produced, the rows told back never reaching the model, half the rows left
out of the fit), the same run comes out not correct. The control, the port's
TF32 path on the card at the cell's size, must come out not correct too."""
import json
import math

import numpy as np
import pytest
import torch

from h100_bench import harness, registry
from h100_bench.reference import gp as ref

CELLS = ["matern52_n4096.seq"]


def _small(cell_name, rows=48, dtype="float64"):
    bench = registry.load_benchmark()
    w = registry.cell(bench, cell_name)
    cfg = registry.config(bench, w["config"])
    cfg.update(rows=rows, dtype=dtype)
    cfg["bo"]["max_iters"] = 5
    return cfg, registry.traffic(w["traffic"]), registry.limits(cell_name)


def test_matern52_matches_its_closed_form():
    X = torch.tensor([[0.0, 0.0], [0.3, -0.4]], dtype=torch.float64)
    k = ref.Kernel({"family": "matern52_ard"},
                   {"variance": torch.tensor(2.0, dtype=torch.float64),
                    "lengthscale": torch.tensor([0.5, 2.0], dtype=torch.float64)})
    r = math.sqrt((0.3 / 0.5) ** 2 + (0.4 / 2.0) ** 2)
    want = 2.0 * (1 + math.sqrt(5) * r + 5 / 3 * r * r) * math.exp(-math.sqrt(5) * r)
    K = k.K(X, X)
    assert float(K[0, 1]) == pytest.approx(want, rel=1e-14)
    assert float(K[0, 0]) == pytest.approx(2.0, rel=1e-14)


def test_gower_is_a_product_of_one_factor_a_dimension():
    spec = {"family": "gower_matern52", "continuous_dims": [0], "ranges": [4.0]}
    k = ref.Kernel(spec, {"variance": torch.tensor(1.5, dtype=torch.float64)})
    X = torch.tensor([[0.0, 1.0], [2.0, 1.0], [2.0, 2.0]], dtype=torch.float64)
    K = k.K(X, X)
    f = lambda r: 1.5 * (1 + math.sqrt(5) * r + 5 / 3 * r * r) * math.exp(-math.sqrt(5) * r)
    assert float(K[0, 1]) == pytest.approx(f(0.5) * f(0.0), rel=1e-14)
    assert float(K[1, 2]) == pytest.approx(f(0.0) * f(1.0), rel=1e-14)
    assert float(k.Kdiag(X)[0]) == 1.5  # the variance, not variance^D


def test_lml_and_gradient_match_a_dense_float64_computation():
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.uniform(-2, 2, (20, 3)))
    Y = torch.as_tensor(rng.standard_normal((20, 1)))
    stated = {"noise_floor": 0.0, "noise_jitter": 1e-8, "jitter_base": 1e-6}
    vals = {"variance": np.array([1.3]), "lengthscale": np.array([0.7, 1.1, 0.9])}
    spec = {"family": "matern52_ard"}
    nlml, grads = ref.neg_lml_grad(spec, X, Y, vals, 1e-3, stated, rung=0)
    Yn = ((Y - Y.mean()) / Y.std(unbiased=False)).numpy()
    params = {k: torch.as_tensor(v) for k, v in vals.items()}
    K = ref.Kernel(spec, params).K(X, X).numpy() + (1e-3 + 1e-8) * np.eye(20)
    sign, logdet = np.linalg.slogdet(K)
    dense = 0.5 * (20 * math.log(2 * math.pi) + logdet + (Yn.T @ np.linalg.solve(K, Yn)).item())
    assert nlml == pytest.approx(dense, rel=1e-12)
    # the gradient in the softplus coordinates by central differences
    u0 = np.log(np.expm1(vals["lengthscale"][1]))
    h = 1e-6
    def at(u):
        v = dict(vals, lengthscale=vals["lengthscale"].copy())
        v["lengthscale"][1] = np.log1p(np.exp(u))
        return ref.neg_lml_grad(spec, X, Y, v, 1e-3, stated, rung=0)[0]
    fd = (at(u0 + h) - at(u0 - h)) / (2 * h)
    assert float(grads["lengthscale"][1]) == pytest.approx(fd, rel=1e-6)


def test_jitter_rung_and_padding_follow_the_stated_rule():
    K = torch.eye(5, dtype=torch.float64) * 2.0
    stated = {"noise_floor": 1e-4, "noise_jitter": 1e-8, "jitter_base": 1e-6}
    Ky, jitter, pad = ref.gram(K, 1e-6, stated, rung=3)
    assert pad == 11  # the 16-row bucket's empty rows
    diag_mean = (5 * (2.0 + 1e-4) + 11) / 16
    assert jitter == pytest.approx(diag_mean * 1e-6 * 100)
    assert float(Ky[0, 0]) == pytest.approx(2.0 + 1e-4 + jitter)


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_reads_rounding_and_is_correct(cell_name):
    cfg, mix, limits = _small(cell_name)
    r = harness.run_cell(cell_name, cfg, mix, 2 ** 31 + 21, 0.5, False, torch.device("cpu"),
                         limits)
    for name, row in r["checks"].items():
        assert row["value"] <= 1e-6, (name, row)
    assert r["correct"], r["checks"]


def _break_answer(monkeypatch, cfg):
    """The suggested row moved inside the domain after its acquisition was
    read."""
    from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer

    optimize = AcquisitionOptimizer.optimize

    def altered(self, *a, **k):
        x, f = optimize(self, *a, **k)
        x = np.array(x)
        x[0, 0] = -0.5 * x[0, 0]
        return x, f

    monkeypatch.setattr(AcquisitionOptimizer, "optimize", altered)


def _break_tell(monkeypatch, cfg):
    """The rows told back never reach the model: its state stays as it was
    before the first round."""
    from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel

    update = GPModel.updateModel

    def stale(self, X_all, Y_all, *a, **k):
        return update(self, X_all[:cfg["rows"]], Y_all[:cfg["rows"]], *a, **k)

    monkeypatch.setattr(GPModel, "updateModel", stale)


def _break_half(monkeypatch, cfg):
    """Half of the rows left out of the fit and the posterior."""
    from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel

    update = GPModel.updateModel

    def half(self, X_all, Y_all, *a, **k):
        n = len(X_all) // 2
        return update(self, X_all[:n], Y_all[:n], *a, **k)

    monkeypatch.setattr(GPModel, "updateModel", half)


@pytest.mark.parametrize("fault", [_break_answer, _break_tell, _break_half],
                         ids=["answer_altered", "state_unchanged", "half_left_out"])
@pytest.mark.parametrize("cell_name", CELLS)
def test_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    cfg, mix, limits = _small(cell_name)
    fault(monkeypatch, cfg)
    r = harness.run_cell(cell_name, cfg, mix, 2 ** 31 + 22, 0.5, False, torch.device("cpu"),
                         limits)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_tf32_control_is_not_correct_on_the_card(cell_name, card):
    """The port's TF32 path (GPO_TPU_MATMUL_PRECISION=high) at the cell's
    size, one round: the control fails the cell's limits."""
    bench = registry.load_benchmark()
    w = registry.cell(bench, cell_name)
    r = harness.run_cell(cell_name, registry.config(bench, w["config"]),
                         registry.traffic(w["traffic"]), 2 ** 31 + 23, 0.1, False, card,
                         registry.limits(cell_name), control="tf32")
    assert not r["correct"], json.dumps(r["checks"])
