"""The benchmark's harness: the cells found by name (``cells``), the
traffic generator (``traffic``), the weights (``weights``), what it takes
from the program (``program``), a run (``runner``), the trace
(``trace``), the peaks and kernel counts (``peaks``) and the comparison
that decides ``correct`` (``compare``)."""
