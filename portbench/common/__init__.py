"""Helpers shared by the runners and the metric readers."""
