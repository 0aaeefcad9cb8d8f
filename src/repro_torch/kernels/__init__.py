"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
bindings, their plain PyTorch versions (``ref.py``) and the dispatch
wrappers (``ops.py``). Nothing is compiled at import: ``build.py``
runs ``nvcc`` the first time a wrapper launches a kernel."""
