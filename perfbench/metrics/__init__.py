"""Per-layer metric readers, one file per metric, and the yardstick
(``_yardstick.py``)."""
