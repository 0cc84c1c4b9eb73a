"""Model zoo of the port: the dense decoder family (``transformer``)."""
