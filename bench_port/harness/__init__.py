"""The benchmark's harness: cells, configurations and metrics found by
file, the closed loop, the traced run."""
