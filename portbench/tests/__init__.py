"""CPU tests of the benchmark, and its tests for the card (marked ``cuda``)."""
