"""Builds `scripts/exr_oracle.cpp` (the OpenEXR library as an oracle) into
`build/` with g++ and writes the OpenEXR fixtures of the port's reader to
`tests/data/exr/`: each `.exr` written by the library beside the library's
decode of every channel as `.npz` (channel name -> its samples, bits as
the library returned them).

    python scripts/make_exr_fixtures.py            # rebuild the fixtures
    python scripts/make_exr_fixtures.py --check    # compare, write nothing

Fixtures: DWAA / DWAB files at several compression levels (RGB, RGBA with
A run-length coded, FLOAT channels, an unknown-named channel, a UINT
channel, two R, G, B sets of one prefix each, a pLinear channel, negative,
zero, inf and NaN samples, data windows away from the origin), and one
luminance/chroma file (`RgbaOutputFile` with WRITE_YC or WRITE_YCA: Y,
RY and BY, the chroma 2x2 subsampled) under each of the ten compressions.
Their sizes are odd where the format allows it (a subsampled channel needs
a data window of even size).  `*_cv2.npy` (cv2's reads of the
luminance/chroma files) come from `scripts/cv2_exr_reads.py`, run where
cv2 has OpenEXR.

The oracle needs g++ and OpenEXR 3.1's headers and libraries
(`/usr/include/OpenEXR`, `-lOpenEXR-3_1`); the helpers below are also the
live-oracle tests' (`tests/test_torch_exr_dwa.py`).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "scripts", "exr_oracle.cpp")
BINARY = os.path.join(ROOT, "build", "exr_oracle")
FIXTURES = os.path.join(ROOT, "tests", "data", "exr")
INCLUDES = ("/usr/include/OpenEXR", "/usr/include/Imath")
LIBS = ("-lOpenEXR-3_1", "-lImath-3_1", "-lIex-3_1")
COMPRESSIONS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A",
                "DWAA", "DWAB")
TYPES = {"uint": np.dtype("<u4"), "half": np.dtype("<f2"),
         "float": np.dtype("<f4")}
TYPE_NAMES = {v: k for k, v in TYPES.items()}


def oracle_missing() -> str:
    """Why the oracle cannot be built here, or '' if it can."""
    if shutil.which("g++") is None:
        return "no g++"
    for d in INCLUDES:
        if not os.path.isdir(d):
            return f"no OpenEXR 3 headers ({d})"
    return ""


def build_oracle(force: bool = False) -> str:
    """Compiles the oracle (about 2 s) unless a build newer than its source
    exists; returns its path."""
    if (not force and os.path.exists(BINARY)
            and os.path.getmtime(BINARY) >= os.path.getmtime(SOURCE)):
        return BINARY
    os.makedirs(os.path.dirname(BINARY), exist_ok=True)
    tmp = f"{BINARY}.{os.getpid()}.tmp"      # test workers may build at once
    cmd = ["g++", "-O2", "-std=c++17"] + [f"-I{d}" for d in INCLUDES] + [
        SOURCE, "-o", tmp] + list(LIBS)
    subprocess.run(cmd, check=True)
    os.replace(tmp, BINARY)
    return BINARY


def _run(args: list) -> str:
    r = subprocess.run([build_oracle()] + [str(a) for a in args],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr.strip())
    return r.stdout


def oracle_write(path: str, comp: str, channels: dict, size, origin=(0, 0),
                 level: float = 45.0, sampling=None, plinear=()) -> None:
    """The library writes `channels` (name -> its samples, (ny_c, nx_c) of
    uint32, float16 or float32) into a scanline file of data window
    `origin` + `size` (H, W)."""
    sampling = sampling or {}
    h, w = size
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "planes.raw")
        with open(raw, "wb") as f:
            for p in channels.values():
                f.write(np.ascontiguousarray(p).astype(
                    p.dtype.newbyteorder("<")).tobytes())
        specs = [f"{n}:{TYPE_NAMES[p.dtype.newbyteorder('<')]}:"
                 f"{sampling.get(n, (1, 1))[0]}:{sampling.get(n, (1, 1))[1]}:"
                 f"{int(n in plinear)}" for n, p in channels.items()]
        _run(["write", path, comp, level, origin[0], origin[1], w, h, raw]
             + specs)


def oracle_yc(path: str, comp: str, rgba: np.ndarray, alpha: bool,
              level: float = 45.0) -> None:
    """RgbaOutputFile writes half RGBA (H, W, 4) as a luminance/chroma file
    (WRITE_YC, or WRITE_YCA with `alpha`)."""
    h, w = rgba.shape[:2]
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "rgba.raw")
        rgba.astype("<f2").tofile(raw)
        _run(["yc", path, comp, level, w, h, "yca" if alpha else "yc", raw])


def oracle_read(path: str) -> dict:
    """The library's decode: channel name -> (ny_c, nx_c) samples."""
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "out.raw")
        info = _run(["read", path, raw])
        buf = open(raw, "rb").read()
    out, pos = {}, 0
    for line in info.splitlines():
        name, kind, _, _, nx, ny = line.split()
        dt = TYPES[kind]
        n = int(nx) * int(ny)
        out[name] = np.frombuffer(buf, dt, n, pos).reshape(int(ny), int(nx))
        pos += n * dt.itemsize
    return out


def _field(rng, h: int, w: int, scale: float = 4.0, offset: float = 0.2,
           noise: float = 0.05):
    """A smooth seeded field with fine noise, as images are."""
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(3.0, 11.0, 4)
    v = (np.sin(xx / f[0] + f[2]) * np.cos(yy / f[1] + f[3]) + 1.0 + offset)
    return scale * v * (1.0 + noise * rng.standard_normal((h, w)))


def dwa_fixtures(rng) -> list:
    """[(name, writer kwargs)] of the DWA fixtures."""
    out = []

    def planes(h, w, spec):
        return {n: _field(rng, h, w, s, noise=0.004).astype(t)
                for n, (t, s) in spec.items()}
    half, flt, uint = np.float16, np.float32, np.uint32
    rgb = {"B": (half, 4.0), "G": (half, 3.0), "R": (half, 5.0)}
    out.append(("dwaa_rgb_l45", dict(comp="DWAA", size=(45, 37),
                                     channels=planes(45, 37, rgb))))
    rgba = dict(rgb, A=(half, 0.4))
    out.append(("dwaa_rgba_l5", dict(comp="DWAA", size=(41, 37), level=5.0,
                                     channels=planes(41, 37, rgba))))
    out.append(("dwab_rgb_l200", dict(comp="DWAB", size=(129, 19),
                                      level=200.0,
                                      channels=planes(129, 19, rgb))))
    mixed = {"B": (flt, 4.0), "G": (flt, 3.0), "R": (flt, 5.0),
             "Z": (flt, 300.0), "depth": (half, 9.0), "id": (uint, 1e4)}
    ch = planes(29, 37, mixed)
    ch["id"] = np.floor(ch["id"]).astype(uint)
    out.append(("dwab_float_l45", dict(comp="DWAB", size=(29, 37),
                                       origin=(-5, 7), channels=ch)))
    sets = {"A": (flt, 0.5), "Y": (half, 2.0), "left.B": (half, 4.0),
            "left.G": (half, 3.0), "left.R": (half, 5.0),
            "right.B": (flt, 40.0), "right.G": (flt, 30.0),
            "right.R": (flt, 50.0)}
    out.append(("dwaa_sets_l45", dict(comp="DWAA", size=(27, 35),
                                      origin=(3, -2), plinear=("Y",),
                                      channels=planes(27, 35, sets))))
    sp = planes(27, 29, rgb)
    for n, p in sp.items():
        p -= 2.0
        p[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 65504.0]
        p[3:11, 3:11] = -60000.0
        p[12:20, 12:20] = 6e-8
        p[21:, 20:] = 0.0
    out.append(("dwab_special_l45", dict(comp="DWAB", size=(27, 29),
                                         channels=sp)))
    return out


def yc_fixtures(rng) -> list:
    """[(name, RGBA half, alpha, compression)]: WRITE_YC and WRITE_YCA in
    turn over the ten compressions, 18 x 26 pixels (34 x 50 under PIZ and
    DWA, whose chunks would not shrink below that and be stored raw)."""
    out = []
    for k, comp in enumerate(COMPRESSIONS):
        h, w = (34, 50) if comp in ("PIZ", "DWAA", "DWAB") else (18, 26)
        rgba = np.stack([_field(rng, h, w, s, noise=0.0)
                         for s in (5.0, 3.0, 2.0, .5)], axis=-1)
        if comp == "PIZ":
            # red and blue well above the luminance keep RY and BY
            # positive: PIZ's bitmap of the values present then spans a
            # few hundred bytes (both signs would span 4 KB, and no chunk
            # would shrink)
            rgba[..., 0] += 2.0
            rgba[..., 1] *= 0.15
            rgba[..., 2] += 0.5 * rgba[..., 0]
        else:
            rgba[:4, :6, :3] = 0.0                  # black: Y = 0
            rgba[-3:, -5:, :3] = [60.0, 0.1, 0.1]   # saturated red
        out.append((f"yc_{comp.lower()}", rgba.astype(np.float16),
                    k % 2 == 1, comp))
    return out


def write_fixtures(dest: str) -> list:
    rng = np.random.default_rng(20260)
    os.makedirs(dest, exist_ok=True)
    names = []
    for name, kw in dwa_fixtures(rng):
        path = os.path.join(dest, name + ".exr")
        oracle_write(path, kw.pop("comp"), kw.pop("channels"), **kw)
        names.append(name)
    for name, rgba, alpha, comp in yc_fixtures(rng):
        oracle_yc(os.path.join(dest, name + ".exr"), comp, rgba, alpha)
        names.append(name)
    for name in names:
        np.savez_compressed(os.path.join(dest, name + ".npz"),
                            **oracle_read(os.path.join(dest, name + ".exr")))
    return names


def main(argv: list) -> int:
    why = oracle_missing()
    if why:
        print(f"cannot build the OpenEXR oracle: {why}", file=sys.stderr)
        return 1
    build_oracle()
    if "--check" not in argv:
        names = write_fixtures(FIXTURES)
        total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                    for f in os.listdir(FIXTURES))
        print(f"{len(names)} fixtures, {total} bytes in {FIXTURES}")
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        names = write_fixtures(tmp)
        same = [n for n in names if all(
            open(os.path.join(tmp, n + e), "rb").read()
            == open(os.path.join(FIXTURES, n + e), "rb").read()
            for e in (".exr",))]
    print(f"{len(same)} of {len(names)} fixtures rebuilt byte for byte")
    return 0 if len(same) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
