"""The benchmark of ``d3net_tpu_torch`` (``python3 perfbench/run.py``)."""
