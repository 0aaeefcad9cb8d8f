"""The benchmark's harness: cells found by name (``cells``), the inputs
from the seed (``traffic``, through the cell's kind), the program's run
with its phases and spans (``program``), the profiler's reduction
(``trace``) and one run's result (``bench``)."""
