"""Imaging operators: host planning, kernel wrappers and their plain
PyTorch versions."""
