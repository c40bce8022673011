"""The plain reference the benchmark judges the program by.

Plain PyTorch and NumPy only: nothing here imports the program
(``deal_and_ceed_on_gpu_torch``), the JAX package or JAX. It works out the
operator from the mesh numbers and the 1D basis itself (``basis``,
``brick``), the right-hand sides from the seed (``brick.load_vector``), its
own CG (``cg``) and the storage precisions of the controls
(``precision``).
"""
