"""The plain reference that decides ``correct``: NumPy only, nothing of
the port, nothing of the JAX package.  ``capture`` replays the quantized
calibration forward, ``cim`` the cycle tables, allocators and analytic
model, ``fabric`` the FIFO event engine."""
