"""Mixed continuous / discrete design space with the Gower kernel,
local-penalization batches, constraint checks, pool-restricted selection and
resumable ask-tell (twin of ``examples/mixed_design_batch.py``):

- a mixed 4-discrete + 2-continuous space (run.py define_variables:166-190)
- the latin_mixed initial design
- pre-check constraints that penalize the objective (run.py pre_check_constraints:266)
- ask-tell with LP batches (test.py:439-508) and finite-pool selection
  (run.py get_configurations:1234-1267)
- state save / resume (.npz in place of run.py's spreadsheet)

Run: python -m gaussian_process_optimization_tpu_torch.examples.mixed_design_batch
"""
from pathlib import Path

import numpy as np

from ..bo import BayesianOptimization, DesignSpace, initial_design
from ..bo.pool import metamodel_rmse, suggest_from_pool
from ..utils import serialization as ser
from ..utils.normalizer import normalize_stats

DOMAIN = [
    {"name": "motor", "type": "discrete", "domain": (0, 1, 2, 3)},
    {"name": "prop", "type": "discrete", "domain": (0, 1, 2, 3, 4)},
    {"name": "battery", "type": "discrete", "domain": (0, 1, 2)},
    {"name": "esc", "type": "discrete", "domain": (0, 1)},
    {"name": "span", "type": "continuous", "domain": (0.5, 2.0)},
    {"name": "chord", "type": "continuous", "domain": (0.05, 0.4)},
]

PENALTY = 50.0


def objective(X):
    """Synthetic stand-in for the drone-configuration objective, with a
    feasibility pre-check that penalizes (run.py pre/post_check_constraints)."""
    X = np.atleast_2d(X)
    motor, prop, battery, esc, span, chord = X.T
    aspect = span / np.maximum(chord, 1e-6)
    drag = 0.1 * chord * span + 0.02 * (prop - 2) ** 2
    weight = 0.3 * motor + 0.2 * battery + 2.0 * chord * span
    efficiency = -np.cos(aspect / 4.0) + 0.05 * (motor - battery) ** 2
    f = drag + 0.3 * weight + efficiency
    infeasible = (aspect > 20) | (esc < motor / 3.0)
    return np.where(infeasible, f + PENALTY, f)[:, None]


def main(iterations=4, batch=3, seed=0, state_file="mixed_bo_state.npz", device=None,
         dtype=None):
    # ask-tell (f=None) needs X and Y at construction: build or resume the design first
    if Path(state_file).exists():
        X, Y, _ = ser.load_bo_state(state_file)
        print(f"resumed {len(X)} evaluations from {state_file}")
    else:
        X = initial_design("latin_mixed", DesignSpace(DOMAIN), 12, seed=seed)
        Y = objective(X)

    bo = BayesianOptimization(f=None, domain=DOMAIN, X=X, Y=Y, model_type="GP",
                              acquisition_type="EI", evaluator_type="local_penalization",
                              batch_size=batch, Gower=True, noise_var=1e-4,
                              de_duplication=True, seed=seed, device=device, dtype=dtype)

    for it in range(iterations):
        bo.X, bo.Y = X, Y
        batch_X = bo.suggest_next_locations()
        X = np.vstack([X, batch_X])
        Y = np.vstack([Y, objective(batch_X)])
        print(f"iter {it}: batch =\n{batch_X}\n  best so far: {Y.min():.4f}")
        ser.save_bo_state(bo, state_file)

    # finite-pool selection over the full discrete grid x a continuous slice
    grid = bo.space.get_discrete_grid()
    pool = np.hstack([grid, np.full((len(grid), 1), 1.2), np.full((len(grid), 1), 0.2)])
    idx, picks = suggest_from_pool(bo.evaluator.acquisition, pool, bo.space, batch_size=3)
    print(f"pool picks (from {len(pool)} configurations):\n{picks}")

    # the surrogate is trained on 'stats'-normalized Y: score in those units
    rmse = metamodel_rmse(bo.model, X, np.asarray(normalize_stats(Y)))
    print(f"surrogate RMSE on evaluated points (normalized units): {rmse:.4f}")
    print(f"best configuration: {X[np.argmin(Y[:, 0])]}, f = {Y.min():.4f}")
    return X, Y


if __name__ == "__main__":
    main()
