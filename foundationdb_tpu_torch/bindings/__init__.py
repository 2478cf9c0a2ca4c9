"""Client bindings: the C-ABI-shaped surface and its conformance tester."""
