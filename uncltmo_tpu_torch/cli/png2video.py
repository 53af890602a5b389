"""Assemble tone-mapped PNG frames into an AVI clip (port of
`cli/png2video.py`; reference `png2video.py:9-32`): MJPG, 20 fps,
1280x720, each frame's mean exposure equalised to the first frame's.  A
host tool: cv2 decodes, resizes and encodes, imported inside `main`.

    python -m uncltmo_tpu_torch.cli.png2video --input_dir frames/ \
        --output clip.avi
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output", default="output.avi")
    p.add_argument("--fps", type=int, default=20)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    args = p.parse_args(argv)

    import cv2
    names = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith(".png"))
    if not names:
        raise SystemExit(f"no PNG frames in {args.input_dir}")
    writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*"MJPG"),
                             args.fps, (args.width, args.height))
    ref_mean = None
    for name in names:
        im = cv2.imread(os.path.join(args.input_dir, name))
        im = cv2.resize(im, (args.width, args.height))
        mean = im.astype(np.float64).mean()
        if ref_mean is None:
            ref_mean = mean
        else:
            im = np.clip(im.astype(np.float64) * (ref_mean / max(mean, 1e-6)),
                         0, 255).astype(np.uint8)
        writer.write(im)
    writer.release()
    print(f"wrote {args.output} ({len(names)} frames)")


if __name__ == "__main__":
    main()
