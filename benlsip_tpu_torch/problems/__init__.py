"""Problem-family generators."""
