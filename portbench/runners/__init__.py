"""The entries that traffic mixes call, one module each, found by the
``runner`` name in a mix's file."""
