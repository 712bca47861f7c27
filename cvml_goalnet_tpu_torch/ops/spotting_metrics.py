"""Event-spotting evaluation: tolerance-windowed precision/recall + average-mAP.

The port's own copy of ``cvml_goalnet_tpu/ops/spotting_metrics.py`` (host
NumPy, unchanged): a predicted event at frame t matches a ground-truth event
at g iff ``|t - g| ≤ tolerance``, one-to-one greedy matching in score order,
giving precision/recall/F1 per tolerance and an average precision over a
tolerance sweep (the SoccerNet "average-mAP" construction).
"""

from __future__ import annotations

import numpy as np


def match_events(
    pred_frames: np.ndarray,
    pred_scores: np.ndarray,
    gt_frames: np.ndarray,
    tolerance: int,
) -> np.ndarray:
    """Greedy one-to-one matching in descending score order.

    Returns a boolean array over predictions: True where matched to an
    unclaimed ground-truth event within ``tolerance`` frames.
    """
    order = np.argsort(-np.asarray(pred_scores))
    claimed = np.zeros(len(gt_frames), dtype=bool)
    matched = np.zeros(len(pred_frames), dtype=bool)
    gt = np.asarray(gt_frames)
    for i in order:
        if len(gt) == 0:
            break
        d = np.abs(gt - pred_frames[i])
        d[claimed] = tolerance + 1
        j = int(np.argmin(d))
        if d[j] <= tolerance:
            claimed[j] = True
            matched[i] = True
    return matched


def spotting_pr(
    pred_frames, pred_scores, gt_frames, tolerance: int
) -> tuple[float, float, float]:
    """(precision, recall, f1) at one tolerance.

    Empty-vs-empty is vacuously PERFECT (1, 1, 1): a class with no ground
    truth and no predictions is the correct output, and reporting f1=0 for
    it is indistinguishable from total failure (round-3 review)."""
    pred_frames = np.asarray(pred_frames)
    gt_frames = np.asarray(gt_frames)
    if len(pred_frames) == 0:
        if len(gt_frames) == 0:
            return 1.0, 1.0, 1.0
        return 0.0, 0.0, 0.0
    matched = match_events(pred_frames, pred_scores, gt_frames, tolerance)
    tp = int(matched.sum())
    precision = tp / len(pred_frames)
    recall = tp / len(gt_frames) if len(gt_frames) else 1.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return precision, recall, f1


def average_precision(
    pred_frames, pred_scores, gt_frames, tolerance: int
) -> float:
    """AP at one tolerance: precision-recall curve over the score ranking."""
    pred_frames = np.asarray(pred_frames)
    if len(pred_frames) == 0 or len(gt_frames) == 0:
        return 0.0
    matched = match_events(pred_frames, pred_scores, gt_frames, tolerance)
    order = np.argsort(-np.asarray(pred_scores))
    tps = matched[order].astype(np.float64)
    cum_tp = np.cumsum(tps)
    precision = cum_tp / (np.arange(len(tps)) + 1)
    recall = cum_tp / len(gt_frames)
    # standard AP: sum precision at each recall step
    return float(np.sum(precision * tps) / len(gt_frames))


def average_map(
    pred_frames, pred_scores, gt_frames, tolerances=(5, 10, 20, 40, 60)
) -> dict:
    """AP averaged over a tolerance sweep + per-tolerance breakdown."""
    aps = {int(t): average_precision(pred_frames, pred_scores, gt_frames, t) for t in tolerances}
    return {"average_map": float(np.mean(list(aps.values()))), "per_tolerance": aps}


def multiclass_average_map(
    pred_by_class, scores_by_class, gt_by_class, tolerances=(5, 10, 20, 40, 60)
) -> dict:
    """SoccerNet-style multi-class average-mAP: per-class AP sweep + the mean
    over classes WITH ground truth.  ``*_by_class`` are equal-length
    sequences (one entry per event class) of frame-index / score arrays.

    Classes absent from a match's ground truth are excluded from the mean
    (the SoccerNet convention): with 17 configured classes and 5 present, a
    model scoring those 5 perfectly used to report ~0.29 instead of 1.0 —
    the forced AP=0 for absent classes systematically deflated the metric
    (round-3 review).  Per-class entries still report every class, with
    ``"present"`` marking whether it counted."""
    per_class = []
    present_maps = []
    for p, s, g in zip(pred_by_class, scores_by_class, gt_by_class):
        entry = average_map(p, s, g, tolerances)
        entry["present"] = bool(len(np.asarray(g)))
        if entry["present"]:
            present_maps.append(entry["average_map"])
        per_class.append(entry)
    return {
        "average_map": float(np.mean(present_maps)) if present_maps else 0.0,
        "per_class": per_class,
    }
