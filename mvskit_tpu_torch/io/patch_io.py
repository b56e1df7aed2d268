# Copy of mvskit_tpu/io/patch_io.py; the port imports nothing of mvskit_tpu.
""".patch checkpoint format.

The reference's text serialization doubles as its checkpoint/resume and
stage-isolation test mechanism (reference pmmvps/patch.cpp:31-79,
patch_manager.cpp:435-523; SURVEY.md §4). Kept byte-compatible so runs
can resume from — and be cross-validated against — reference outputs.

Layout:
    PATCHES
    <count>
    then per patch (operator<< patch.cpp:58-79):
    PATCHES
    cx cy cz cw
    nx ny nz nw
    ncc dscale ascale
    <n_images>
    id id ...
    <n_vimages>
    id id ...

Image ids in the file are dataset image *ids*; in-memory lists hold
*indices* (the reference converts with image2index/index2image,
patch_manager.cpp:53-73).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def read_patch_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a .patch file. Returns dict with coord [N,4], normal [N,4],
    ncc/dscale/ascale [N], images and vimages as object arrays of
    python lists (ids, untranslated)."""
    with open(path, "r") as f:
        toks = f.read().split()
    pos = 0

    def take(n=1):
        nonlocal pos
        out = toks[pos : pos + n]
        pos += n
        return out

    header = take()[0]
    if header not in ("PATCHES", "PATCHA"):
        raise ValueError(f"bad patch file header {header!r}")
    count = int(take()[0])

    coord = np.zeros((count, 4))
    normal = np.zeros((count, 4))
    ncc = np.zeros(count)
    dscale = np.zeros(count)
    ascale = np.zeros(count)
    images: List[List[int]] = []
    vimages: List[List[int]] = []

    for p in range(count):
        hdr = take()[0]
        coord[p] = [float(v) for v in take(4)]
        normal[p] = [float(v) for v in take(4)]
        ncc[p], dscale[p], ascale[p] = (float(v) for v in take(3))
        if hdr == "PATCHA":  # extended record (patch.cpp:37-41)
            take(5)  # type + dir4
        ni = int(take()[0])
        images.append([int(v) for v in take(ni)])
        nv = int(take()[0])
        vimages.append([int(v) for v in take(nv)])

    return {
        "coord": coord,
        "normal": normal,
        "ncc": ncc,
        "dscale": dscale,
        "ascale": ascale,
        "images": images,
        "vimages": vimages,
    }


def write_patch_file(
    path: str,
    coord: np.ndarray,
    normal: np.ndarray,
    ncc: np.ndarray,
    dscale: np.ndarray,
    ascale: np.ndarray,
    images: Sequence[Sequence[int]],
    vimages: Sequence[Sequence[int]],
) -> None:
    n = coord.shape[0]
    with open(path, "w") as f:
        f.write(f"PATCHES\n{n}\n")
        for p in range(n):
            f.write("PATCHES\n")
            f.write(" ".join(repr(float(v)) for v in coord[p]) + "\n")
            f.write(" ".join(repr(float(v)) for v in normal[p]) + "\n")
            f.write(
                f"{float(ncc[p])!r} {float(dscale[p])!r} {float(ascale[p])!r}\n"
            )
            f.write(f"{len(images[p])}\n")
            f.write(" ".join(str(int(v)) for v in images[p]) + "\n")
            f.write(f"{len(vimages[p])}\n")
            f.write(" ".join(str(int(v)) for v in vimages[p]) + "\n")


def lists_to_padded(lists: Sequence[Sequence[int]], width: int) -> np.ndarray:
    out = np.full((len(lists), width), -1, np.int32)
    for i, lst in enumerate(lists):
        k = min(len(lst), width)
        out[i, :k] = lst[:k]
    return out


def padded_to_lists(arr: np.ndarray) -> List[List[int]]:
    return [[int(v) for v in row[row >= 0]] for row in arr]
