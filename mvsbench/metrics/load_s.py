"""Seconds of scene load: decoding the images and building the pyramids
(``PMMVS.__init__``; image/scene.py, image/decode.py), averaged over
the window's untraced reconstructions."""


def read(r):
    return r.span_seconds("load")
