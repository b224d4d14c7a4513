"""Frozen input generators: the benchmark's inputs, drawn from ``--seed``."""
