"""Drivers of a traffic mix's ``loop`` kind: one module a kind, found by
that name."""
