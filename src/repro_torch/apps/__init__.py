"""Sample applications of the port (§5): ``streamlines``."""
