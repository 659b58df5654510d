"""Planning and dispatch layers of the port."""
