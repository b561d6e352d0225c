"""The yardstick shared by every cell: specs, guards, data, weights, work
counts, peaks, trace reduction and the correctness comparisons."""
