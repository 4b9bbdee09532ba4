"""Bayesian optimization of Branin with EI (twin of ``examples/branin_bo.py``;
BASELINE config 3): the one-stop BayesianOptimization entry point, convergence and
acquisition plots, TSV reports.

Run: python -m gaussian_process_optimization_tpu_torch.examples.branin_bo
"""
from ..bo import BayesianOptimization, bounds_to_space, objectives


def main(max_iter=25, seed=0, plot=True, device=None, dtype=None):
    bo = BayesianOptimization(
        f=objectives.branin,
        domain=bounds_to_space(objectives.branin.bounds),
        acquisition_type="EI",
        initial_design_numdata=5,
        initial_design_type="latin",
        exact_feval=True,
        seed=seed,
        device=device,
        dtype=dtype,
    )
    bo.run_optimization(max_iter=max_iter, eps=-1, report_file="branin_report.txt",
                        evaluations_file="branin_evaluations.txt")
    print(f"best f = {bo.fx_opt:.5f} (true fmin = {objectives.branin.fmin}) at x = {bo.x_opt}")
    if plot:
        bo.plot_convergence("branin_convergence.png")
        bo.plot_acquisition("branin_acquisition.png")
        print("wrote branin_convergence.png, branin_acquisition.png")
    return bo


if __name__ == "__main__":
    main()
