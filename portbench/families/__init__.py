"""Adapters from a configuration's ``family`` to the port's entry points:
one module a family, found by that name."""
