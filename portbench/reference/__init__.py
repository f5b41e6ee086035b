"""Plain float32 references, one file a configuration, found by its name.
They import nothing of the port."""
