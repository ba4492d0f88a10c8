"""The benchmark of the PyTorch and CUDA port (`hitadv_torch`): one run
of one cell is ``python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see `bench_port/run.py`)."""
