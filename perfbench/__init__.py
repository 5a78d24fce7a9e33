"""The benchmark of `escgnn_tpu_torch` on the H100: one command runs one
cell of `BENCHMARK.json` once (`python3 -m perfbench.run --help`)."""
