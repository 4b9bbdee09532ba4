"""Example scripts and the demo gallery (twins of the repository's ``examples/``),
on this package. Each runs on the card unless given ``device``; run one with
``python -m gaussian_process_optimization_tpu_torch.examples.<name>``."""
