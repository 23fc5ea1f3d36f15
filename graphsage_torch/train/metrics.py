"""Evaluation metrics.

The reference scores with ``sklearn.metrics.f1_score(average="micro")``
(src/utils.py:34,46).  For single-label multiclass prediction micro-F1
equals accuracy (micro precision = micro recall = accuracy); implemented
directly so the metric runs anywhere without sklearn on the path.
"""

from __future__ import annotations

import numpy as np


def micro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    assert y_true.shape == y_pred.shape
    if y_true.size == 0:
        return 0.0
    return float((y_true == y_pred).mean())
