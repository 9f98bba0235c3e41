"""The benchmark's core: the cell's files by name (spec), the inputs of a
run (inputs, and the frozen sphere in meshes), what the entry adapters
share (adapter), the measured window (window), the trace (trace), the
comparison that decides `correct` (checks) and one run of a cell (cell).
The generators, adapters and metric readers are files of their own under
benchmark/inputs/, benchmark/entries/ and benchmark/metrics/."""
