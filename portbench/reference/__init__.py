"""The plain reference the correctness check compares the program with.

Plain PyTorch and numpy only: nothing here imports JAX, the JAX package or
anything of the program (``dvae_tpu_torch``).  ``model`` is the coupled
mixture VAE of MMIDAS (mmidas/nn_model.py) written out from its equations;
``philox`` the counter-based generator whose bits the program's fused
encoder kernel turns into its dropout mask; ``draws`` the order in which
the program's epoch runner draws its randomness, so that the reference
works out the same noise again from the same seeds.
"""
