"""The benchmark of the PyTorch and CUDA port (``mpcgpu_tpu_torch``).
Entry point: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
