"""CPU tests of the benchmark harness (not collected by the repository's tests/)."""
