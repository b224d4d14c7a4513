"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy; it imports nothing of the program (neither
``katsdpimager_tpu_torch`` nor the JAX package) and works out again
whatever the program derives from the inputs.
"""
