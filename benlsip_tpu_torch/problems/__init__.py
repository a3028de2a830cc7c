"""Problem fixtures and family generators of the port."""
