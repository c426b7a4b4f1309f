"""The benchmark's harness, driven by BENCHMARK.json and the data files beside it."""
