"""portbench: the benchmark of the PyTorch/CUDA port ``repro_torch``.

``run.py`` runs one cell (``workloads/<name>.json``) of the paper's FL
round through ``repro_torch.engine`` on the card and prints one JSON
result line. ``reference/`` is the plain PyTorch / NumPy reference that
decides ``correct``; ``kinds/`` what differs between kinds of model
(inputs, the program's pieces, the reference's batches, the work
counts); ``work/`` the frozen FLOP and byte counts and the card's peaks;
``metrics/`` one reader per metric. See ``README.md``.
"""
