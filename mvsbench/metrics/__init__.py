"""Per-layer metric readers, one file each, found by the metric's name:
``metrics/<name>.py`` defines ``read(reading)``, which takes the
window's ``trace.Reading`` (``trace.py``) and returns the metric's
value, or None where it finds nothing to read."""
