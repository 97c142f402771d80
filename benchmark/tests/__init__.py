"""CPU tests of the benchmark (pytest benchmark/tests); the `cuda` ones run
a cell on the card."""
