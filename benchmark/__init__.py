"""The benchmark of the PyTorch and CUDA port, ``ess_tpu_torch``, on NVIDIA
GPUs: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (``BENCHMARK.json`` lists the cells)."""
