"""The plain fp32 reference: the models and the optimizer written from
their published descriptions in plain PyTorch, with no kernel, cache or
batching.  It imports nothing of the port; the weights it reads are the
benchmark's own (:mod:`gpubench.weights`), drawn again from the seed.
"""
