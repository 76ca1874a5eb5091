"""Plain NumPy references, one module a model, named by a configuration's
`reference` key."""
