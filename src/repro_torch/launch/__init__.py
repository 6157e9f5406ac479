"""Process entry points of the port (``repro/launch``): ``serve`` (one batch
through the engine) and ``server`` (the HTTP/SSE front door, one engine or a
replica pool). Both run on the CUDA device unless ``--device cpu``."""
