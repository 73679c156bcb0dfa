"""The benchmark of sphtpu_torch (see README.md); `run.py` is its command."""
