"""In-training evaluation, the `Tester` (port of
`uncltmo_tpu/training/tester.py`; reference `Tester.py` for video and
`TesterImg.py` for images).

Every 1/4 epoch the trainer hands the Tester its generator's weights; the
Tester runs them over held-out HDR content with `TileEngine` (so both
kernels, K1 and K2, on the card), scores each render with TMQI on the
device, and for video adds the warp error of a scene's first two renders.
The metrics go into the name of the result directory (`Tester.py:282`),
next to the rendered PNGs.  Missing lambdas of the eval set are fitted at
construction when a mean histogram is configured; eval directories that do
not exist are skipped, so a trainer runs without them.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from uncltmo_tpu_torch.config import Options
from uncltmo_tpu_torch.inference.engine import TileEngine
from uncltmo_tpu_torch.inference.runner import (postprocess_device,
                                                preprocess_device)
from uncltmo_tpu_torch.metrics.tmqi import tmqi
from uncltmo_tpu_torch.metrics.warp_error import compute_warp_error
from uncltmo_tpu_torch.ops import preprocess
from uncltmo_tpu_torch.utils.io import (HDR_EXTENSIONS, list_hdr_names,
                                        load_lambda_dict, read_hdr_image,
                                        save_uint8_png)


class Tester:
    """Evaluates `model`'s architecture with the weights each call of
    `save_images_for_model` brings.  The engine runs a copy of `model` in
    `dtype` on `device` (the card unless the caller asks for the CPU): the
    caller's module, a trainer's float32 generator, is left as it is."""

    def __init__(self, opt: Options, model: torch.nn.Module,
                 video: bool = False, test_video_path: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.opt = opt
        self.video = video
        self.test_video_path = test_video_path
        self.device = torch.device(device)
        self.engine = TileEngine(model, dtype=dtype, device=self.device)
        self.lambda_table: Dict[str, float] = {}
        if opt.f_factor_path and os.path.exists(opt.f_factor_path):
            self.lambda_table = load_lambda_dict(opt.f_factor_path)
        self._maybe_calc_lambdas(opt.test_dataroot_original_hdr)
        self.original_hdr = self._preload(opt.test_dataroot_original_hdr)

    def _maybe_calc_lambdas(self, root: Optional[str]) -> None:
        """Fit the lambdas the eval set lacks, as the reference's Tester
        does at construction (`Tester.py:40-42`).  Needs `mean_hist_path`;
        without it a missing name raises in `_lambda_for`."""
        if not root or not os.path.isdir(root):
            return
        missing = any(
            os.path.splitext(n)[0] not in self.lambda_table
            for n in os.listdir(root)
            if os.path.splitext(n)[1] in HDR_EXTENSIONS)
        hist = self.opt.mean_hist_path
        if not missing or not hist or not os.path.exists(hist):
            return
        from uncltmo_tpu_torch.ops.lambda_est import calc_lambda
        os.makedirs(self.opt.lambdas_path, exist_ok=True)
        # seed calc_lambda's cache with the lambdas already known, so it
        # fits only the missing names (it skips stems of its output dict)
        out_path = os.path.join(self.opt.lambdas_path,
                                "input_images_lambdas.npy")
        cache = {}
        if os.path.isfile(out_path):
            cache = np.load(out_path, allow_pickle=True)[()]
        merged = {**cache, **self.lambda_table}
        if merged != cache:
            np.save(out_path, merged)
        out = calc_lambda(self.opt.f_factor_path, HDR_EXTENSIONS, root,
                          hist, self.opt.lambdas_path, self.opt.bins,
                          device=self.device)
        if out and os.path.exists(out):
            self.lambda_table = {**load_lambda_dict(out), **self.lambda_table}

    def _lambda_for(self, name: str) -> float:
        """The brightness factor of an eval image or scene.  A missing name
        raises, as the reference's `get_f` does (`data_loader_util.py:
        212-222`): a mistyped dataset must not evaluate with a wrong
        lambda."""
        if name not in self.lambda_table:
            raise KeyError(
                f"no lambda for {name!r} in {self.opt.f_factor_path!r}; "
                "run uncltmo_tpu_torch.cli.prepare_lambdas for this dataset")
        return float(self.lambda_table[name]) * 255.0 * self.opt.factor_coeff

    def _load(self, path: str, f_factor):
        """One HDR file -> (raw rgb, padded rgb, padded gray, dy, dx): the
        raw image on the host, as the JAX Tester keeps it (TMQI takes it to
        the device when it scores), the rest on the device."""
        rgb_raw = read_hdr_image(path)
        rgb, gray = preprocess_device(
            torch.from_numpy(rgb_raw).to(self.device), f_factor,
            self.opt.data_trc)
        rgb_p, dy, dx = preprocess.pad_to_unet_grid(rgb)
        gray_p, dy, dx = preprocess.pad_to_unet_grid(gray)
        return rgb_raw, rgb_p, gray_p, dy, dx

    def _preload(self, root: Optional[str]) -> List[Dict]:
        """The eval images, preprocessed and padded, kept on the device
        (`Tester.py:40-61`); their raw images stay on the host."""
        items = []
        if not root or not os.path.isdir(root):
            return items
        for img_name in list_hdr_names(root):
            stem = os.path.splitext(img_name)[0]
            raw, rgb_p, gray_p, dy, dx = self._load(
                os.path.join(root, img_name), self._lambda_for(stem))
            items.append({"im_name": stem, "rgb": rgb_p, "gray": gray_p,
                          "rgb_original": raw, "diffY": dy, "diffX": dx})
        return items

    def save_images_for_model(self, state_dict, out_dir: str, epoch: int,
                              epoch_iter: int) -> Dict[str, float]:
        """The 1/4-epoch eval (`Tester.py:253-312`): load `state_dict` (the
        generator's, on any device; the trainer hands its live one) into
        the engine, score the eval set, and write the renders to
        {out_dir}/model_results/epoch{E}_iter{I}_{metrics}/color_stretch."""
        self.engine.update_variables(state_dict)
        metrics: Dict = {}
        renders: Optional[List[torch.Tensor]] = None
        if self.video and self.test_video_path and \
                os.path.isdir(self.test_video_path):
            tm, w1, w2, flow_info = self.eval_on_video_root(
                self.test_video_path)
            metrics.update(tmqi=tm, warp_e1=w1, warp_e2=w2)
            # warp errors compare within one (flow_algo, flow_source) only
            metrics.update(flow_info)
            tag = f"m1st{tm}_m2nd{w1}_m3rd{w2}"
        elif self.original_hdr:
            # the renders are kept for the PNGs: one forward per image
            tm, renders = self._eval_images_with_renders()
            metrics.update(tmqi=tm)
            tag = f"tmqi{tm}"
        else:
            tag = "noeval"
        result_dir = os.path.join(
            out_dir, "model_results",
            f"epoch{epoch}_iter{epoch_iter}_{tag}", "color_stretch")
        for i, item in enumerate(self.original_hdr):
            out01 = renders[i] if renders is not None else self._render(item)
            save_uint8_png(out01.cpu().numpy(), result_dir,
                           item["im_name"] + "_color_stretch")
        return metrics

    def _render(self, item) -> torch.Tensor:
        """One eval image -> its tone-mapped (H, W, 3) render in [0, 1]."""
        if self.video:
            # the frame replicated 4x through the recurrent model, the last
            # frame kept (`Tester.py:291-300`)
            fake = self.engine.run_video(torch.stack([item["gray"]] * 4))[-1]
        else:
            fake = self.engine.run_image(item["gray"])
        return postprocess_device(item["rgb"], fake, item["diffY"],
                                  item["diffX"])

    def _score(self, rgb_original: np.ndarray, out01: torch.Tensor
               ) -> float:
        return tmqi(rgb_original, out01 * 255.0, device=self.device)[0]

    def _eval_images_with_renders(self):
        """(mean TMQI, the renders) of the eval images (`TesterImg.py:
        310-373`): each image rendered once for both."""
        scores, renders = [], []
        for item in self.original_hdr:
            out01 = self._render(item)
            renders.append(out01)
            scores.append(self._score(item["rgb_original"], out01))
        return (float(np.mean(scores)) if scores else 0.0), renders

    def _baseline_flow_pair(self, scene: str, names: List[str]):
        """The L1L0 baseline renders of a scene's first two frames, the
        warp error's flow source in the paper's protocol (`Tester.py:
        378-385`: '<dir>/<scene>/<frame>_L1L0TM.png', read by cv2.imread,
        so BGR).  (None, None) when `baseline_flow_dir` is not set or a
        file is missing: the flow then comes from the model's own renders,
        which is not the protocol."""
        base = getattr(self.opt, "baseline_flow_dir", "none")
        if not base or base == "none":
            return None, None
        import cv2
        pair = []
        for nm in names:
            p = os.path.join(base, scene,
                             os.path.splitext(nm)[0] + "_L1L0TM.png")
            img = cv2.imread(p) if os.path.exists(p) else None
            if img is None:
                return None, None
            pair.append(img)
        return pair[0], pair[1]

    def eval_on_video_root(self, root: str, frames_per_scene: int = 6):
        """Per-scene TMQI and warp error (`Tester.py:314-392`) over the
        scene directories of `root`, the first `frames_per_scene` frames
        each.  Returns (mean TMQI, mean E1, mean E2, the flow provenance),
        the provenance {} when no scene had two frames."""
        tmqi_total, e1_total, e2_total, n = 0.0, 0.0, 0.0, 0
        flow_info: Dict[str, str] = {}
        for scene in sorted(os.listdir(root)):
            scene_dir = os.path.join(root, scene)
            if not os.path.isdir(scene_dir):
                continue
            names = list_hdr_names(scene_dir)[:frames_per_scene]
            if not names:
                # a stray directory must not end the training run
                continue
            f_factor = self._lambda_for(scene)
            loaded = [self._load(os.path.join(scene_dir, nm), f_factor)
                      for nm in names]
            _, _, _, dy, dx = loaded[-1]
            fakes = self.engine.run_video(torch.stack([ld[2]
                                                       for ld in loaded]))
            scene_q, rendered = 0.0, []
            for (raw, rgb_p, _, _, _), fake in zip(loaded, fakes):
                out01 = postprocess_device(rgb_p, fake, dy, dx)
                rendered.append(out01)
                scene_q += self._score(raw, out01)
            tmqi_total += scene_q / len(names)
            if len(rendered) >= 2:
                src0, src1 = self._baseline_flow_pair(scene, names[:2])
                e1, e2, flow_info = compute_warp_error(
                    rendered[0], rendered[1], flow_source0=src0,
                    flow_source1=src1, with_provenance=True,
                    device=self.device)
                e1_total += e1
                e2_total += e2
            n += 1
        if n == 0:
            return 0.0, 0.0, 0.0, {}
        return tmqi_total / n, e1_total / n, e2_total / n, flow_info
