"""The benchmark of `avtubes_torch` on NVIDIA H100 cards: `python3 -m
perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.
See `perfbench/run.py` and `PERF.md`."""
