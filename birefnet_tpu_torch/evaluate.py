"""Evaluation metrics for dichotomous image segmentation.

Counterpart of birefnet_tpu/evaluate.py, copied so that the port needs
nothing of the JAX package: the standard DIS/SOD benchmark metrics the
upstream BiRefNet paper reports, so a finetune run (finetune.py) can be
scored without leaving the package:

- MAE           mean absolute error between prediction and ground truth.
- F-measure     precision/recall harmonic mean with beta^2 = 0.3
                (Achanta et al., FT; the SOD convention), reported both
                adaptively thresholded (2x mean, the common "adp" variant)
                and as the max over 256 thresholds ("maxF").
- S-measure     structure measure (Fan et al., ICCV 2017): alpha-blend of
                object-aware and region-aware structural similarity,
                alpha = 0.5, evaluated on the CONTINUOUS prediction.
- E-measure     enhanced-alignment measure (Fan et al., IJCAI 2018) on the
                binarized prediction: adaptive threshold and max over 256
                thresholds.
- weighted F    F-beta^w (Margolin et al., CVPR 2014 "How to Evaluate
                Foreground Maps"): errors are dependency-weighted (nearest
                -foreground Gaussian pooling) and distance-attenuated
                before the precision/recall harmonic mean; beta = 1.

Pure numpy on the host (evaluation is IO-bound post-processing, not a
device workload); formulas transcribed from the published definitions,
with the degenerate cases (empty / full ground truth) handled as in the
papers.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np

_EPS = 1e-8


def _validate(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if pred.shape != gt.shape or pred.ndim != 2:
        raise ValueError(f"pred/gt must be same-shape 2-D maps; got "
                         f"{pred.shape} vs {gt.shape}")
    if pred.min() < 0 or pred.max() > 1 + 1e-6:
        raise ValueError("pred must be in [0, 1] (apply sigmoid / /255 first)")
    gt = (gt > 0.5).astype(np.float64)
    return pred, gt


def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    pred, gt = _validate(pred, gt)
    return float(np.abs(pred - gt).mean())


def _precision_recall(pred: np.ndarray, gt: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized P/R over thresholds via the histogram trick: bucket pred
    values, then cumulative sums give TP / predicted-positive counts for
    every threshold at once."""
    n_gt = gt.sum()
    # bins: threshold t selects pred >= t; histogram pred into 256 bins.
    fg_hist, _ = np.histogram(pred[gt == 1], bins=256, range=(0.0, 1.0 + 1e-9))
    all_hist, _ = np.histogram(pred, bins=256, range=(0.0, 1.0 + 1e-9))
    # cum from the top: counts with pred in [t, 1]
    tp = np.cumsum(fg_hist[::-1])[::-1].astype(np.float64)
    pp = np.cumsum(all_hist[::-1])[::-1].astype(np.float64)
    # thresholds are the 256 bin lower edges
    precision = tp / (pp + _EPS)
    recall = tp / (n_gt + _EPS)
    return precision, recall


def f_measure(pred: np.ndarray, gt: np.ndarray,
              beta2: float = 0.3) -> Dict[str, float]:
    """adpF (adaptive threshold = 2*mean(pred), clipped to 1) and maxF
    (max over 256 thresholds)."""
    pred, gt = _validate(pred, gt)
    precision, recall = _precision_recall(pred, gt)
    f = ((1 + beta2) * precision * recall
         / (beta2 * precision + recall + _EPS))
    max_f = float(f.max())

    t = min(2.0 * pred.mean(), 1.0)
    binary = pred >= t
    tp = float((binary & (gt == 1)).sum())
    p = tp / (binary.sum() + _EPS)
    r = tp / (gt.sum() + _EPS)
    adp_f = float((1 + beta2) * p * r / (beta2 * p + r + _EPS))
    return {"adp": adp_f, "max": max_f}


def weighted_f_measure(pred: np.ndarray, gt: np.ndarray,
                       beta2: float = 1.0) -> float:
    """F-beta^w (Margolin et al., CVPR 2014), the upstream BiRefNet eval
    table's weighted F column. Transcribed from the published WFb
    definition:

    - E = |pred - gt|; background errors are replaced by the error at the
      NEAREST foreground pixel (bwdist index transform), then pooled with
      a 7x7 sigma=5 Gaussian (MATLAB fspecial semantics, zero-padded);
      foreground errors take min(E, pooled E).
    - Background errors are further attenuated by
      B = 2 - exp(log(0.5)/5 * dist-to-foreground).
    - Weighted TP/FP then form precision; weighted recall is
      1 - mean(Ew over foreground); F = (1+b^2)PR/(b^2*P + R).
    """
    from scipy import ndimage

    pred, gt = _validate(pred, gt)
    if gt.sum() == 0:
        # The published code requires a non-empty GT; the standard
        # toolbox convention scores an empty-GT frame 0.
        return 0.0
    gtb = gt.astype(bool)

    e = np.abs(pred - gt)
    # bwdist(gt): distance to (and index of) the nearest FOREGROUND pixel.
    dst, (iy, ix) = ndimage.distance_transform_edt(
        ~gtb, return_indices=True)
    et = e.copy()
    et[~gtb] = et[iy[~gtb], ix[~gtb]]
    # fspecial('gaussian', 7, 5), imfilter zero-padded.
    ax = np.arange(-3, 4, dtype=np.float64)
    k1 = np.exp(-(ax ** 2) / (2 * 5.0 ** 2))
    k = np.outer(k1, k1)
    k /= k.sum()
    ea = ndimage.convolve(et, k, mode="constant", cval=0.0)
    min_e_ea = e.copy()
    sel = gtb & (ea < e)
    min_e_ea[sel] = ea[sel]
    b = np.ones_like(gt)
    b[~gtb] = 2.0 - np.exp(np.log(0.5) / 5.0 * dst[~gtb])
    ew = min_e_ea * b

    tpw = gt.sum() - ew[gtb].sum()
    fpw = ew[~gtb].sum()
    r = 1.0 - ew[gtb].mean()
    p = tpw / (tpw + fpw + _EPS)
    return float((1 + beta2) * r * p / (r + beta2 * p + _EPS))


# --------------------------- S-measure -------------------------------------

def _s_object_term(x: np.ndarray) -> float:
    """2*mean / (mean^2 + 1 + std + eps) over the given values."""
    if x.size == 0:
        return 0.0
    m, s = x.mean(), x.std()
    return float(2.0 * m / (m * m + 1.0 + s + _EPS))


def _s_object(pred: np.ndarray, gt: np.ndarray) -> float:
    mu = gt.mean()
    o_fg = _s_object_term(pred[gt == 1])
    o_bg = _s_object_term((1.0 - pred)[gt == 0])
    return mu * o_fg + (1.0 - mu) * o_bg


def _centroid(gt: np.ndarray) -> Tuple[int, int]:
    h, w = gt.shape
    if gt.sum() == 0:
        return h // 2, w // 2
    ys, xs = np.nonzero(gt)
    return int(round(ys.mean())), int(round(xs.mean()))


def _region_ssim(x: np.ndarray, y: np.ndarray) -> float:
    """Fan's region similarity (SSIM-shaped, with the published special
    cases at zero alpha/beta)."""
    n = x.size
    if n <= 1:
        return 1.0 if np.allclose(x, y) else 0.0
    mx, my = x.mean(), y.mean()
    sx = ((x - mx) ** 2).sum() / (n - 1)
    sy = ((y - my) ** 2).sum() / (n - 1)
    sxy = ((x - mx) * (y - my)).sum() / (n - 1)
    alpha = 4.0 * mx * my * sxy
    beta = (mx * mx + my * my) * (sx + sy)
    if alpha != 0:
        return float(alpha / (beta + _EPS))
    if alpha == 0 and beta == 0:
        return 1.0
    return 0.0


def _s_region(pred: np.ndarray, gt: np.ndarray) -> float:
    cy, cx = _centroid(gt)
    h, w = gt.shape
    cy, cx = max(cy, 1), max(cx, 1)  # keep all four regions non-empty
    total = h * w
    score = 0.0
    for sl in ((slice(0, cy), slice(0, cx)),
               (slice(0, cy), slice(cx, w)),
               (slice(cy, h), slice(0, cx)),
               (slice(cy, h), slice(cx, w))):
        px, gx = pred[sl], gt[sl]
        score += (gx.size / total) * _region_ssim(px, gx)
    return score


def s_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    """Structure measure (Fan et al. 2017) on the continuous prediction."""
    pred, gt = _validate(pred, gt)
    mu = gt.mean()
    if mu == 0:  # all-background GT: score the prediction's emptiness
        return float(1.0 - pred.mean())
    if mu == 1:  # all-foreground GT
        return float(pred.mean())
    s = alpha * _s_object(pred, gt) + (1 - alpha) * _s_region(pred, gt)
    return float(max(s, 0.0))


# --------------------------- E-measure -------------------------------------

def _e_measure_binary(binary: np.ndarray, gt: np.ndarray) -> float:
    """Enhanced-alignment on one binarized prediction (Fan et al. 2018)."""
    gt_sum = gt.sum()
    if gt_sum == 0:  # published degenerate cases
        return float(1.0 - binary.mean())
    if gt_sum == gt.size:
        return float(binary.mean())
    phi_gt = gt - gt.mean()
    phi_p = binary.astype(np.float64) - binary.mean()
    align = 2.0 * phi_gt * phi_p / (phi_gt ** 2 + phi_p ** 2 + _EPS)
    enhanced = (align + 1.0) ** 2 / 4.0
    return float(enhanced.sum() / (gt.size - 1 + _EPS))


def e_measure(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """adpE (adaptive 2*mean threshold) and maxE (max over 256 thresholds)."""
    pred, gt = _validate(pred, gt)
    t_adp = min(2.0 * pred.mean(), 1.0)
    adp = _e_measure_binary(pred >= t_adp, gt)
    best = 0.0
    for t in np.linspace(0, 1, 256):
        best = max(best, _e_measure_binary(pred >= t, gt))
    return {"adp": adp, "max": best}


# --------------------------- batch driver -----------------------------------

def evaluate_maps(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]
                  ) -> Dict[str, float]:
    """Average the four metrics over (pred, gt) map pairs."""
    sums: Dict[str, float] = {}
    n = 0
    for pred, gt in pairs:
        f = f_measure(pred, gt)
        e = e_measure(pred, gt)
        vals = {"mae": mae(pred, gt), "s_measure": s_measure(pred, gt),
                "weighted_f": weighted_f_measure(pred, gt),
                "adp_f": f["adp"], "max_f": f["max"],
                "adp_e": e["adp"], "max_e": e["max"]}
        for k, v in vals.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    if n == 0:
        raise ValueError("no (pred, gt) pairs to evaluate")
    return {k: v / n for k, v in sums.items()}


def main(argv=None) -> int:
    import argparse

    from .finetune import find_pairs

    parser = argparse.ArgumentParser(
        description="Score predicted masks against ground truth "
                    "(MAE / F / S / E measures)")
    parser.add_argument("pred_dir", help="predicted masks (grayscale images)")
    parser.add_argument("gt_dir", help="ground-truth masks (same stems)")
    args = parser.parse_args(argv)

    from PIL import Image

    def load(path):
        return np.asarray(Image.open(path).convert("L"),
                          dtype=np.float64) / 255.0

    def gen():
        for pp, gp in find_pairs(args.pred_dir, args.gt_dir):
            p, g = load(pp), load(gp)
            if p.shape != g.shape:  # score at GT resolution
                p = np.asarray(Image.fromarray(
                    (p * 255).astype(np.uint8)).resize(
                    g.shape[::-1], Image.BILINEAR), dtype=np.float64) / 255.0
            yield p, g

    scores = evaluate_maps(gen())
    for k, v in scores.items():
        print(f"{k:10s} {v:.4f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
