"""Model zoo of the port: the dense decoder family (``transformer``) and the
hybrid RG-LRU + local-attention family (``rglru``)."""
