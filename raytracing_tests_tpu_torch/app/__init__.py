"""Application layer: a headless CLI that lists and runs workloads and writes
PNG outputs."""
