"""Dataset-scale evaluation on one device (``parallel/eval.py``)."""
