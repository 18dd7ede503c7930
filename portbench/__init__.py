"""The benchmark of the PyTorch and CUDA port ``repro_torch`` on the H100.

Run from the root of a checkout:
``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(README.md in this folder).
"""
