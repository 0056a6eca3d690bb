"""The systems under test: thin adapters that build the port's entry point
for a configuration from the benchmark's made data and weights."""
