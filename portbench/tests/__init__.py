"""Tests of the benchmark itself (``pytest portbench/tests``)."""
