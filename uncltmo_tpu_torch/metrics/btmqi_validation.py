"""The validation harness of the reconstructed BTMQI features (port of
`uncltmo_tpu/metrics/btmqi_validation.py`): a deterministic distortion
corpus (over- and under-exposure, gamma, blur and noise ladders on seeded
synthetic renders), the fraction of each ladder each blind scorer ranks in
order, and the Spearman agreement between the scorers over the pooled
corpus.  The corpus and the statistics are numpy on the host; the features
run on `device` through the port's `btmqi`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from uncltmo_tpu_torch.metrics.btmqi import SVRModel, btmqi

# ---------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------


def make_base_render(seed: int = 0, size: int = 192) -> np.ndarray:
    """A deterministic synthetic 'well tone-mapped' grayscale render in
    [0, 1]: a smooth seeded luminance field plus band-limited detail,
    affinely placed at the TMQI naturalness priors' sweet spot
    (mean ~116/255, local std ~25/255 — `TMQI.py:224-235`)."""
    rng = np.random.default_rng(seed)
    base = rng.random((size // 8, size // 8)).astype(np.float64)
    # bilinear upsample -> smooth large-scale structure
    idx = np.linspace(0, base.shape[0] - 1, size)
    i0 = np.floor(idx).astype(int)
    i1 = np.minimum(i0 + 1, base.shape[0] - 1)
    w = (idx - i0)[:, None]
    rows = base[i0] * (1 - w) + base[i1] * w
    w2 = (idx - i0)[None, :]
    smooth = rows[:, i0] * (1 - w2) + rows[:, i1] * w2
    detail = rng.normal(0.0, 1.0, (size, size))
    # 3x3 box smoothing keeps the detail band-limited (texture, not noise)
    k = np.ones(3) / 3.0
    detail = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 0, detail)
    detail = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="same"), 1, detail)
    im = smooth + 0.25 * detail
    im = (im - im.mean()) / (im.std() + 1e-9)
    return np.clip(116.0 / 255.0 + (25.0 / 255.0) * im, 0.0, 1.0)


def _blur(im: np.ndarray, passes: int) -> np.ndarray:
    k = np.ones(5) / 5.0
    out = im
    for _ in range(passes):
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 0, out)
        out = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, out)
    return out


def distortion_sweeps(base01: np.ndarray,
                      seed: int = 0) -> Dict[str, List[np.ndarray]]:
    """Named distortion ladders; index 0 is the pristine render and the
    distortion strength increases strictly with the index."""
    rng = np.random.default_rng(seed + 1000)
    noise = rng.normal(0.0, 1.0, base01.shape)
    sweeps: Dict[str, List[np.ndarray]] = {
        "over_exposure": [np.clip(base01 * (2.0 ** k), 0.0, 1.0)
                          for k in (0.0, 0.5, 1.0, 1.5, 2.0, 2.5)],
        "under_exposure": [base01 * (2.0 ** -k)
                           for k in (0.0, 0.5, 1.0, 1.5, 2.0, 2.5)],
        "gamma_crush": [base01 ** g for g in (1.0, 2.0, 3.5, 5.0, 7.0)],
        "blur": [_blur(base01, p) for p in (0, 1, 2, 4, 8)],
        "noise": [np.clip(base01 + s * noise, 0.0, 1.0)
                  for s in (0.0, 0.02, 0.05, 0.1, 0.2)],
    }
    return sweeps


# ---------------------------------------------------------------------
# scoring + statistics
# ---------------------------------------------------------------------


def _spearman(a: Sequence[float], b: Sequence[float]) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def _monotone_frac(scores: Sequence[float]) -> float:
    """Fraction of adjacent severity pairs ranked correctly (pristine
    highest): 1.0 = the ladder is perfectly ordered."""
    s = np.asarray(scores, np.float64)
    return float(np.mean(s[:-1] > s[1:]))


def validate(seeds: Sequence[int] = (0, 1, 2),
             model: Optional[SVRModel] = None,
             size: int = 192, device="cuda") -> Dict[str, object]:
    """Score the corpus with every available blind scorer and return:

      sweeps[name][scorer]   mean adjacent-pair monotonicity over seeds
      spearman[pair]         rank agreement over the pooled corpus
      score_range[scorer]    (min, max) observed — the SVR should live
                             inside the published ~1.9..7.9 envelope
    """
    scorers = ["surrogate", "naturalness"] + (["svr"] if model else [])
    pooled: Dict[str, List[float]] = {s: [] for s in scorers}
    mono: Dict[str, Dict[str, List[float]]] = {}
    for seed in seeds:
        base = make_base_render(seed, size=size)
        for name, ladder in distortion_sweeps(base, seed=seed).items():
            per_scorer: Dict[str, List[float]] = {s: [] for s in scorers}
            for im in ladder:
                s_sur, feats = btmqi(im, device=device)
                per_scorer["surrogate"].append(s_sur)
                per_scorer["naturalness"].append(float(feats[9]))
                if model:
                    per_scorer["svr"].append(float(model.predict(feats)))
            for s in scorers:
                mono.setdefault(name, {}).setdefault(s, []).append(
                    _monotone_frac(per_scorer[s]))
                pooled[s].extend(per_scorer[s])
    out_sweeps = {name: {s: float(np.mean(v)) for s, v in d.items()}
                  for name, d in mono.items()}
    pairs = {}
    for i, a in enumerate(scorers):
        for b in scorers[i + 1:]:
            pairs[f"{a}/{b}"] = _spearman(pooled[a], pooled[b])
    ranges = {s: (float(np.min(v)), float(np.max(v)))
              for s, v in pooled.items()}
    return {"sweeps": out_sweeps, "spearman": pairs,
            "score_range": ranges, "n_images": len(pooled[scorers[0]])}
