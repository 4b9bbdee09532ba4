"""Binary-classification reporting (twin of
``gaussian_process_optimization_tpu/utils/classification.py``; GPy
util/classification.py:6).

``conf_matrix`` keeps the reference's return contract: ``(error, true_1,
false_1, true_0, false_0)``, actual classes by column and predicted by row,
for the class-1 probabilities of ``GPClassification.predict``.
"""
from __future__ import annotations

import numpy as np


def conf_matrix(p, labels, names=("1", "0"), threshold=0.5, show=True):
    """Error rate and true / false positives of thresholded class-1
    probabilities ``p`` (array or tensor) against actual ``labels`` (0/1)."""
    if hasattr(p, "detach"):
        p = p.detach().cpu().numpy()
    p = np.asarray(p).reshape(-1, 1)
    labels = np.asarray(labels).reshape(-1, 1)
    if p.size != labels.size:
        raise ValueError("Arrays p and labels have different dimensions.")
    decision = (p >= threshold).astype(float)
    diff = decision - labels
    false_0 = int((diff == -1).sum())  # predicted 0, actually 1
    false_1 = int((diff == 1).sum())   # predicted 1, actually 0
    true_1 = int(decision[diff == 0].sum())
    true_0 = int(labels.size - true_1 - false_0 - false_1)
    error = (false_1 + false_0) / float(labels.size)
    if show:
        print(100.0 - error * 100.0, "% instances correctly classified")
        print("%-10s|  %-10s|  %-10s| " % ("", names[0], names[1]))
        print("----------|------------|------------|")
        print("%-10s|  %-10s|  %-10s| " % (names[0], true_1, false_0))
        print("%-10s|  %-10s|  %-10s| " % (names[1], false_1, true_0))
    return error, true_1, false_1, true_0, false_0
