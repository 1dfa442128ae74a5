"""The benchmark of the PyTorch and CUDA port (``camera_calibration_torch``).

Run one cell with ``python3 calib_bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the repository's root; the cells,
configurations and metrics are in ``BENCHMARK.json``.
"""
