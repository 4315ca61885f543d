"""The benchmark of the PyTorch and CUDA port (``repro_torch``): served
ColPali search, run one cell at a time by ``portbench/run.py``."""
