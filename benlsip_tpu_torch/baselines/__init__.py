"""Independent reference checks of the port (numpy only)."""
