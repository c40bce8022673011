"""The benchmark of ``deal_and_ceed_on_gpu_torch``: one run of one cell a process (``benchmark/run.py``)."""
