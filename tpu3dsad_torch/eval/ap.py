"""Average precision on the host, in numpy (tpu3dsad/eval/ap.py; the
reference scores AP on the host too, so this is its copy).

Per class, detections are matched greedily in descending score order to
unmatched ground truth at IoU >= the threshold; AP is the VOC all-points
area under the PR curve (11-point optional); mAP and AR average over the
classes that have ground truth. The oriented 3D IoU is BEV convex-polygon
clipping times the vertical overlap (Z-up).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


# ------------------------------------------------------------- oriented IoU


def _polygon_clip(subject, clip):
    """Sutherland–Hodgman clipping of convex polygon `subject` by `clip`.

    Both are [N,2] arrays, counter-clockwise. Returns list of points.
    """

    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p1[0] - p2[0], p1[1] - p2[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        if abs(den) < 1e-12:
            return p2
        return (
            (n1 * dp[0] - n2 * dc[0]) / den,
            (n1 * dp[1] - n2 * dc[1]) / den,
        )

    output = [tuple(p) for p in subject]
    for i in range(len(clip)):
        a, b = tuple(clip[i]), tuple(clip[(i + 1) % len(clip)])
        input_list, output = output, []
        if not input_list:
            return []
        s = input_list[-1]
        for e in input_list:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, e, a, b))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersect(s, e, a, b))
            s = e
    return output


def _poly_area(pts):
    if len(pts) < 3:
        return 0.0
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _ccw(quad):
    """Ensure counter-clockwise orientation of a [4,2] quad."""
    area = 0.0
    for i in range(4):
        x1, y1 = quad[i]
        x2, y2 = quad[(i + 1) % 4]
        area += x1 * y2 - x2 * y1
    return quad if area > 0 else quad[::-1]


def box3d_iou_oriented(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """IoU of two oriented 3D boxes given [8,3] corners (top face 0-3, Z-up)."""
    q1 = _ccw(corners1[:4, :2])
    q2 = _ccw(corners2[:4, :2])
    inter2d = _poly_area(_polygon_clip(q1, q2))
    zmax = min(corners1[:, 2].max(), corners2[:, 2].max())
    zmin = max(corners1[:, 2].min(), corners2[:, 2].min())
    inter_h = max(0.0, zmax - zmin)
    inter = inter2d * inter_h
    v1 = _poly_area([tuple(p) for p in q1]) * (
        corners1[:, 2].max() - corners1[:, 2].min()
    )
    v2 = _poly_area([tuple(p) for p in q2]) * (
        corners2[:, 2].max() - corners2[:, 2].min()
    )
    union = v1 + v2 - inter
    return float(inter / union) if union > 1e-12 else 0.0


# ------------------------------------------------------------------- VOC AP


def voc_ap(rec, prec, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(dets, gts, iou_thresh=0.25, iou_fn=box3d_iou_oriented):
    """dets: {scene: [(corners, score), ...]}, gts: {scene: [corners, ...]}.

    Returns (rec, prec, ap) — greedy score-desc matching, one match per GT.
    """
    npos = sum(len(v) for v in gts.values())
    matched = {s: np.zeros(len(v), bool) for s, v in gts.items()}

    records = [
        (score, scene, corners)
        for scene, items in dets.items()
        for corners, score in items
    ]
    records.sort(key=lambda r: -r[0])

    tp = np.zeros(len(records))
    fp = np.zeros(len(records))
    for i, (score, scene, corners) in enumerate(records):
        gt_list = gts.get(scene, [])
        best_iou, best_j = -1.0, -1
        for j, g in enumerate(gt_list):
            iou = iou_fn(corners, g)
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_iou >= iou_thresh and not matched[scene][best_j]:
            matched[scene][best_j] = True
            tp[i] = 1
        else:
            fp[i] = 1

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec)


class APCalculator:
    """Accumulates per-scene predictions/GT; computes per-class AP + mAP."""

    def __init__(self, iou_thresh: float = 0.25, class_names=None,
                 iou_fn=box3d_iou_oriented):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        self.iou_fn = iou_fn
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))  # cls -> scene -> []
        self._gts = defaultdict(lambda: defaultdict(list))
        self._scene = 0

    def step(self, batch_pred, batch_gt):
        """batch_pred: per-scene [(cls, corners, score)], batch_gt: per-scene
        [(cls, corners)] — the lineage batch_*_map_cls format."""
        for preds, gts in zip(batch_pred, batch_gt):
            sid = self._scene
            self._scene += 1
            for cls, corners, score in preds:
                self._dets[cls][sid].append((np.asarray(corners), float(score)))
            for cls, corners in gts:
                self._gts[cls][sid].append(np.asarray(corners))

    def compute_metrics(self) -> dict:
        out = {}
        aps = []
        recalls = []
        for cls in sorted(self._gts.keys()):
            rec, prec, ap = eval_det_cls(
                self._dets.get(cls, {}),
                self._gts[cls],
                self.iou_thresh,
                self.iou_fn,
            )
            name = (
                self.class_names[cls]
                if self.class_names is not None
                else str(cls)
            )
            out[f"{name} AP"] = ap
            out[f"{name} recall"] = float(rec[-1]) if len(rec) else 0.0
            aps.append(ap)
            recalls.append(out[f"{name} recall"])
        out["mAP"] = float(np.mean(aps)) if aps else 0.0
        out["AR"] = float(np.mean(recalls)) if recalls else 0.0
        return out
