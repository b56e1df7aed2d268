# Copy of mvskit_tpu/image/decode.py; the port imports nothing of mvskit_tpu.
"""Host-side image/mask decoding for the TPU PM-MVS engine.

Functional equivalent of the reference's image I/O (reference:
image/image.cpp:827-1022): JPEG/PNG/PPM decode to RGB uint8, binary
PGM (P5) / PBM (P4) mask decode, PGM write. JPEG decoding goes through
PIL (the reference used CImg); PGM/PBM are parsed directly so the byte
semantics match the reference exactly (PBM: bit set = black = masked
out -> 0, clear = 255; reference image.cpp:929-941).
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np


def load_rgb(path: str) -> np.ndarray:
    """Decode an image to [H, W, 3] uint8 RGB.

    Grayscale inputs are expanded to 3 channels (reference
    image.cpp:858-876 does the same CImg spectrum expansion).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".ppm", ".pgm", ".pbm"):
        arr = _read_pnm(path)
    else:
        from PIL import Image as PILImage

        with PILImage.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] > 3:
        arr = arr[:, :, :3]
    return np.ascontiguousarray(arr, dtype=np.uint8)


def save_rgb(path: str, img: np.ndarray) -> None:
    from PIL import Image as PILImage

    PILImage.fromarray(np.asarray(img, dtype=np.uint8)).save(path)


def _read_pnm_header(data: bytes) -> Tuple[bytes, Tuple[int, ...], int]:
    """Parse a PNM header, returning (magic, dims, payload offset)."""
    # tokens separated by whitespace; '#' comments run to end of line
    tokens = []
    pos = 0
    n = len(data)
    magic = None
    while pos < n and len(tokens) < 4:
        c = data[pos : pos + 1]
        if c.isspace():
            pos += 1
            continue
        if c == b"#":
            eol = data.find(b"\n", pos)
            pos = n if eol < 0 else eol + 1
            continue
        m = re.match(rb"[^\s#]+", data[pos:])
        tok = m.group(0)
        pos += len(tok)
        if magic is None:
            magic = tok
            # P1/P4 (bitmap) have no maxval token
            want = 3 if tok in (b"P1", b"P4") else 4
        else:
            tokens.append(int(tok))
        if magic in (b"P1", b"P4") and len(tokens) == 2:
            break
        if magic not in (b"P1", b"P4") and len(tokens) == 3:
            break
    pos += 1  # single whitespace after header
    return magic, tuple(tokens), pos


def _read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic, dims, pos = _read_pnm_header(data)
    if magic == b"P6":  # binary PPM
        w, h, _ = dims
        arr = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
        return arr.reshape(h, w, 3).copy()
    if magic == b"P5":  # binary PGM
        w, h, _ = dims
        arr = np.frombuffer(data, dtype=np.uint8, count=w * h, offset=pos)
        return arr.reshape(h, w).copy()
    if magic == b"P4":  # binary PBM
        w, h = dims
        row_bytes = (w + 7) // 8
        raw = np.frombuffer(
            data, dtype=np.uint8, count=row_bytes * h, offset=pos
        ).reshape(h, row_bytes)
        bits = np.unpackbits(raw, axis=1)[:, :w]
        return bits.astype(np.uint8)
    raise ValueError(f"Unsupported PNM magic {magic!r} in {path}")


def load_mask(path_base: str) -> Optional[np.ndarray]:
    """Load a binary mask from `<path_base>.pgm` or `<path_base>.pbm`.

    Returns [H, W] uint8 with values in {0, 255}, or None if no mask file
    exists. Matches reference thresholding (image.cpp:149-156: PGM >127 ->
    255) and PBM polarity (bit set -> 0).
    """
    pgm = path_base + ".pgm"
    pbm = path_base + ".pbm"
    if os.path.exists(pgm):
        arr = _read_pnm(pgm)
        return np.where(arr > 127, 255, 0).astype(np.uint8)
    if os.path.exists(pbm):
        bits = _read_pnm(pbm)
        return np.where(bits > 0, 0, 255).astype(np.uint8)
    return None


def write_pgm(path: str, img: np.ndarray) -> None:
    """Binary PGM write (reference image.cpp:1000-1022)."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
