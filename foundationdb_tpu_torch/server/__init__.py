"""Server roles of the port (this slice: the resolver)."""
