"""cv2's reads of the OpenEXR fixtures in `tests/data/exr/`, as the JAX
package reads `.exr` (`cv2.imread(path, IMREAD_ANYDEPTH | IMREAD_COLOR)`,
`uncltmo_tpu/utils/io.py:36-40`), for a build of cv2 with OpenEXR:

    python scripts/cv2_exr_reads.py DEST

writes `DEST/<name>_cv2.npy` (float32 RGB, cv2's BGR reversed) for each
fixture cv2 reads, and prints one JSON line: cv2's version and build line,
and per fixture whether cv2 read it and whether the port's `read_exr`
equals cv2's read bit for bit.  The luminance/chroma reads are committed as
`tests/data/exr/yc_*_cv2.npy`, the CPU tests' oracle for the colour step.
"""
from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(dest: str) -> int:
    os.environ["OPENCV_IO_ENABLE_OPENEXR"] = "1"
    import cv2
    sys.path.insert(0, ROOT)
    from uncltmo_tpu_torch.utils.exr import read_exr
    os.makedirs(dest, exist_ok=True)
    line = next((ln.strip() for ln in cv2.getBuildInformation().splitlines()
                 if "OpenEXR" in ln), "")
    rows = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "tests", "data", "exr",
                                              "*.exr"))):
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            bgr = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
        except cv2.error as e:
            bgr, why = None, str(e).strip().splitlines()[-1]
        else:
            why = None
        row = {"cv2_reads": bgr is not None}
        if bgr is None:
            row["why"] = why
        else:
            rgb = np.ascontiguousarray(bgr[..., ::-1]).astype(np.float32)
            np.save(os.path.join(dest, name + "_cv2.npy"), rgb)
            got = read_exr(path)
            row["equal_to_port"] = bool(got.shape == rgb.shape and (
                got.view(np.uint32) == rgb.view(np.uint32)).all())
            if not row["equal_to_port"] and got.shape == rgb.shape:
                row["differing"] = int((got.view(np.uint32)
                                        != rgb.view(np.uint32)).sum())
                with np.errstate(invalid="ignore"):
                    row["max_abs"] = float(np.nanmax(np.abs(got - rgb)))
        rows[name] = row
    print(json.dumps({"cv2": cv2.__version__, "build_line": line,
                      "fixtures": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "build/exr_cv2"))
