"""Chip-side tools that are not part of a benchmark run."""
