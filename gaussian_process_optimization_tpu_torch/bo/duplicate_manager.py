"""De-duplication of suggested points (twin of
``gaussian_process_optimization_tpu/bo/duplicate_manager.py``; GPyOpt
util/duplicate_manager.py:7): a set of evaluated, pending and ignored points,
compared in zipped (objective-space) coordinates."""
from __future__ import annotations

import numpy as np


class DuplicateManager:
    def __init__(self, space, zipped_X, pending_zipped_X=None, ignored_zipped_X=None):
        self.space = space
        self.unique_points = set()
        for block in (zipped_X, pending_zipped_X, ignored_zipped_X):
            if block is None:
                continue
            for row in np.atleast_2d(np.asarray(block, dtype=float)):
                self.unique_points.add(tuple(row))

    def is_zipped_x_duplicate(self, zipped_x):
        return tuple(np.asarray(zipped_x, dtype=float).flatten()) in self.unique_points

    def is_unzipped_x_duplicate(self, unzipped_x):
        """(duplicate_manager.py:37)"""
        return self.is_zipped_x_duplicate(
            self.space.zip_inputs(np.atleast_2d(unzipped_x)).flatten())
