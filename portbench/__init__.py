"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ACORN:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``)."""
