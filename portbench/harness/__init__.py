"""The benchmark's harness: it finds a cell's configuration, traffic mix,
spans and metric readers by name from ``BENCHMARK.json``, makes the cell's
inputs from the seed, runs the timed passes of the port's streaming engine,
reads the trace, and decides ``correct`` against the plain reference."""
