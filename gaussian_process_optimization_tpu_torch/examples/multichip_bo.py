"""Bayesian optimization on a mesh (twin of ``examples/multichip_bo.py``): the
surrogate's multi-restart L-BFGS fits and both acquisition phases (candidate
sweep and anchor polish) split over the shards of a ``parallel/sharded.Mesh``.

On the card the mesh holds four shards: one per card where there are four,
else four shards of card 0. With ``device="cpu"`` it holds eight CPU shards,
as the reference's virtual CPU mesh does.

Run: python -m gaussian_process_optimization_tpu_torch.examples.multichip_bo
"""
import torch

from ..bo import BayesianOptimization, bounds_to_space, objectives
from ..parallel import sharded

CARD_SHARDS, CPU_SHARDS = 4, 8


def make_mesh(device=None):
    """Eight CPU shards for a CPU ``device``; else four shards, one per card
    where there are four, or four of card 0 (or of ``device``)."""
    if device is not None and torch.device(device).type == "cpu":
        return sharded.make_mesh(CPU_SHARDS, device="cpu")
    if device is None and torch.cuda.device_count() >= CARD_SHARDS:
        return sharded.make_mesh(CARD_SHARDS)
    return sharded.make_mesh(CARD_SHARDS, device=device or "cuda:0")


def main(max_iter=10, seed=0, device=None, dtype=None):
    mesh = make_mesh(device)
    n = mesh.shape["data"]
    print(f"mesh: {n} shards on {sorted({str(d) for d in mesh.shards()})}")
    bo = BayesianOptimization(
        f=objectives.branin,
        domain=bounds_to_space(objectives.branin.bounds),
        acquisition_type="EI",
        initial_design_numdata=5,
        initial_design_type="latin",
        exact_feval=True,
        seed=seed,
        mesh=mesh,                 # restart-parallel fits and the sharded acquisition
        optimize_restarts=n,       # one restart chain per shard
        device=device,
        dtype=dtype,
    )
    bo.run_optimization(max_iter=max_iter, eps=-1)
    print(f"best f = {bo.fx_opt:.5f} (true fmin = {objectives.branin.fmin}) at x = {bo.x_opt}")
    return bo


if __name__ == "__main__":
    main()
