"""Plain reference of the paper's FL round (PyTorch and NumPy only).

Nothing here imports the program (``repro_torch``), the JAX package or
JAX: ``rngs`` is a frozen copy of the spawn-tree rule that names every
random stream of a run, ``csma`` frozen copies of the two contention
engines' semantics (the NumPy event loop, and the device loop's candidate
pool and counter-based redraws), ``fl`` the rounds themselves (local SGD,
Eq. 2, Eq. 3 selection with the fairness counter, Eq. 1) and ``judge``
the numbers that decide ``correct``."""
