"""Benchmarks of the port (twins of the repository's ``benchmarks/``); they
print their rows and write no committed artifact."""
