"""The benchmark of the PyTorch port (``repro_torch``): DALI's offloaded
and resident serving of Mixtral-8x7B and DeepSeek-V2-Lite on one H100,
driven by ``BENCHMARK.json`` at the root of the repository.  Run one cell
once with ``python3 dali_bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``."""
