"""Device ops: intersection, shading, film filters, traversal."""
