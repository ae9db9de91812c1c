"""The benchmark of ``ctunet_tpu_torch`` on NVIDIA H100 cards (``run.py``)."""
