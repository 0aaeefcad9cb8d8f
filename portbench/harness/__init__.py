"""The benchmark's harness: cells found by name (``cells``), the one
input generator (``traffic``), the program's run with its phases and
spans (``program``), the profiler's reduction (``trace``) and one run's
result (``bench``)."""
