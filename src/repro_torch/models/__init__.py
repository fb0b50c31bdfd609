"""Model math of the port: config, layers, the dense transformer and the
``build_model`` API."""
