"""Table generators, one module a schema, found by the schema's name."""
