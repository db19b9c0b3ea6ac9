"""The paper's two example algorithms as Stream programs (PyTorch):
the prime sieve and sparse polynomial multiplication."""
