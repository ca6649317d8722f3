"""Evaluation: per-pixel and per-region confusion matrices + pretty printer.

Reference behavior reproduced from annonet_infer_main.cpp:
  * per-pixel confusion over labeled points (:482-489)
  * per-region ("two-way") confusion via majority blob voting with the
    detection-biased background-vote-discard rule (:202-272)
  * recall / precision / accuracy formatting of print_confusion_matrix
    (:101-194)

Matrix convention: first index ground truth, second index predicted
(annonet_infer_main.cpp:91).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from annonet_jax.classes import AnnoClass, IGNORE_LABEL
from annonet_jax.ops.blobs import label_connected_blobs

ConfusionMatrix = np.ndarray  # [K, K] int64, [ground_truth, predicted]


def new_confusion_matrix(class_count: int) -> ConfusionMatrix:
    return np.zeros((class_count, class_count), dtype=np.int64)


def update_confusion_matrix_per_pixel(
    confusion_matrix: ConfusionMatrix,
    labeled_points_by_class: Dict[int, np.ndarray],
    result_label_image: np.ndarray,
) -> int:
    """Accumulate per-pixel counts over labeled points; returns the number of
    ground-truth points consumed (annonet_infer_main.cpp:482-489)."""
    k = confusion_matrix.shape[0]
    count = 0
    for ground_truth, points in labeled_points_by_class.items():
        predicted = result_label_image[points[:, 1], points[:, 0]]
        confusion_matrix[ground_truth] += np.bincount(
            predicted.astype(np.int64), minlength=k
        )[:k]
        count += len(points)
    return count


def _winner(votes: Dict[int, int]) -> int:
    """Class with most votes; IGNORE_LABEL when empty. Ties break to the
    smallest class index (deterministic, unlike the reference's
    unordered_map iteration order)."""
    if not votes:
        return IGNORE_LABEL
    best = max(votes.values())
    return min(c for c, v in votes.items() if v == best)


def update_confusion_matrix_per_region(
    confusion_matrix: ConfusionMatrix,
    labeled_points_by_class: Dict[int, np.ndarray],
    ground_truth_label_image: np.ndarray,
    result_label_image: np.ndarray,
) -> None:
    """Two-way per-region confusion (annonet_infer_main.cpp:202-272):
    blob-label BOTH the ground truth and the prediction (8-conn,
    equal-valued, zero = background), majority-vote each blob over the
    labeled points, and apply the detection-biased rule: when a blob's
    ground truth is predominantly non-background, its background prediction
    votes are discarded unless the prediction is background-only."""
    if not labeled_points_by_class:
        return
    assert ground_truth_label_image.shape == result_label_image.shape

    gt_blobs, gt_count = label_connected_blobs(ground_truth_label_image)
    res_blobs, res_count = label_connected_blobs(result_label_image)

    def vote_blob_class(blob_count: int, blobs: np.ndarray) -> None:
        votes_ground_truth: List[Dict[int, int]] = [
            {} for _ in range(blob_count)
        ]
        votes_predicted: List[Dict[int, int]] = [{} for _ in range(blob_count)]

        for ground_truth, points in labeled_points_by_class.items():
            blob_ids = blobs[points[:, 1], points[:, 0]]
            predicted = result_label_image[points[:, 1], points[:, 0]]
            for blob, pred in zip(blob_ids.tolist(), predicted.tolist()):
                g = votes_ground_truth[blob]
                g[ground_truth] = g.get(ground_truth, 0) + 1
                p = votes_predicted[blob]
                p[pred] = p.get(pred, 0) + 1

        for blob in range(blob_count):
            blob_ground_truth = votes_ground_truth[blob]
            blob_predicted = votes_predicted[blob]

            predominantly_non_background = _winner(blob_ground_truth) != 0
            background_only = set(blob_predicted.keys()) == {0}
            if predominantly_non_background and not background_only:
                blob_predicted.pop(0, None)

            winner_ground_truth = _winner(blob_ground_truth)
            if winner_ground_truth != IGNORE_LABEL:
                winner_predicted = _winner(blob_predicted)
                confusion_matrix[winner_ground_truth][winner_predicted] += 1

    vote_blob_class(gt_count, gt_blobs)
    vote_blob_class(res_count, res_blobs)


def format_confusion_matrix(
    confusion_matrix: ConfusionMatrix, anno_classes: Sequence[AnnoClass]
) -> str:
    """Render the matrix with per-class recall column, precision row, and
    total accuracy — the content of print_confusion_matrix
    (annonet_infer_main.cpp:101-194)."""
    k = len(anno_classes)
    cm = np.asarray(confusion_matrix)
    max_value = int(cm.max()) if cm.size else 0
    value_width = max(len("100 %") + 1, len(str(max_value)) + 2)
    class_width = len(str(k - 1)) + 3
    truth_label = "truth"
    recall_width = len("recall") + 4

    lines: List[str] = []
    header_pad = (
        len(truth_label) + class_width + value_width * k // 2 + len("predicted") // 2
    )
    lines.append("predicted".rjust(header_pad))

    header = " " * (len(truth_label) + class_width)
    for anno_class in anno_classes:
        header += str(anno_class.index).rjust(value_width)
    header += "recall".rjust(recall_width)
    lines.append(header)

    total_predicted = cm.sum(axis=0)
    total = int(cm.sum())
    total_correct = int(np.trace(cm))

    for gt in range(k):
        row = truth_label if gt == (k - 1) // 2 else ""
        row = row.rjust(len(truth_label))
        row += str(gt).rjust(class_width)
        for pred in range(k):
            row += str(int(cm[gt][pred])).rjust(value_width)
        row_total = int(cm[gt].sum())
        if row_total > 0:
            recall = cm[gt][gt] * 100.0 / row_total
            row += f"{recall:.2f} %".rjust(recall_width)
        else:
            row += "-".rjust(recall_width)
        lines.append(row)

    precision_row = "precision".rjust(len(truth_label) + class_width)
    for pred in range(k):
        if total_predicted[pred] > 0:
            precision = cm[pred][pred] * 100.0 / total_predicted[pred]
            precision_row += f"{precision:.2f} %".rjust(value_width)
        else:
            precision_row += "-".rjust(value_width)
    lines.append(precision_row)

    accuracy_line = "accuracy".rjust(
        len(truth_label) + class_width + k * value_width
    )
    if total > 0:
        accuracy_line += f"{total_correct * 100.0 / total:.2f} %".rjust(
            recall_width
        )
    else:
        accuracy_line += "-".rjust(recall_width)
    lines.append(accuracy_line)
    return "\n".join(lines)


def confusion_matrix_summary(
    confusion_matrix: ConfusionMatrix, anno_classes: Sequence[AnnoClass]
) -> Dict:
    """Machine-readable form of format_confusion_matrix: the raw matrix
    plus the derived per-class recall/precision and total accuracy the
    pretty-printer renders (annonet_infer_main.cpp:101-194). Used by
    `annonet_infer --report-json`."""
    cm = np.asarray(confusion_matrix)
    total = int(cm.sum())
    correct = int(np.trace(cm))
    row_totals = cm.sum(axis=1)
    col_totals = cm.sum(axis=0)
    classes = []
    for c in anno_classes:
        i = c.index
        classes.append(
            {
                "index": i,
                "name": c.classlabel,
                "ground_truth_count": int(row_totals[i]),
                "predicted_count": int(col_totals[i]),
                "recall": (
                    float(cm[i, i] / row_totals[i]) if row_totals[i] else None
                ),
                "precision": (
                    float(cm[i, i] / col_totals[i]) if col_totals[i] else None
                ),
            }
        )
    return {
        "matrix": cm.astype(int).tolist(),
        "total": total,
        "accuracy": (correct / total) if total else None,
        "classes": classes,
    }
