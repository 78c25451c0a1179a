"""Seeded inputs of the benchmark."""
